"""Streaming executor: batched launches fed through pinned double buffers.

The paper's overhead story (§III-A.2) is that OpenCLIPER hides transfer
housekeeping with pinned-memory buffer mapping, so that host<->device
traffic overlaps compute.  ``init()/launch()`` moves one Data set a
launch: pack, upload, launch, repeat.  This module runs many independent
Data sets (MRI slice stacks, inference requests) through one process, the
counterpart of ``repro/core/stream.py``:

* :class:`BatchedProcess` -- a **twin** of the process wired for ``rows``
  items: every streamed input, every Data the process writes (a scratch
  arena, the output) gets a Data whose entries carry a leading ``rows``
  axis (:func:`~repro_torch.core.arena.batched_layout`), static inputs
  stay as they are (one map set broadcast to every item), and the twin is
  launched as any process is (:meth:`~repro_torch.core.process.Process.
  launch`: on the card eager once, then captured into a CUDA graph and
  replayed).  The JAX package ``vmap``s one compiled program over stacked
  item blobs; a batch axis written out takes its place.  A replay reads
  the addresses it was captured on, so each upload slot has a twin of its
  own (its own blobs and graph): twins are kept per ``(rows, slot)`` on
  the process and reused by later streams, until its ``init()``.

* :class:`StreamQueue` -- a bounded host->device feed over a ring of
  ``depth`` upload slots.  Each slot has a pinned host buffer, allocated
  once with the twin, into which an item's arrays are copied straight into
  their rows (no per-call pack and pin, as ``CLapp.host2device`` does);
  the copy runs on the app's copy stream after an event recorded behind
  the last launch that read the slot (never behind the whole compute
  stream, which would serialise every upload behind the launch before
  it), and the compute stream waits on the copy's event.  A pinned buffer
  is refilled only after its last copy's event completed.  With ``depth =
  2`` batch i+1 uploads while batch i computes.

* :class:`_BatchPlan` -- the ragged-tail policy of the JAX package
  (:meth:`_BatchPlan.launch_rows`): a last batch with fewer than ``batch``
  items is padded by repeating its last item when the waste is at most
  ``tail_waste_threshold``, or else launched by a twin for its own row
  count, set up before the launch loop (:meth:`_BatchPlan.precompile`).

* :class:`_JoinFeed` -- multi-input (fan-in) streaming: one row-aligned
  feed per streamed input, one group plan for all of them.

* :func:`stream_launch` -- the engine behind ``Process.stream`` and the
  Pipeline's ``mode="stream"``.  Each batch's output is copied device to
  device into a new ``(rows, out_total_bytes)`` stack of item blobs (a
  twin's output is overwritten by its next launch), and each item's
  result is a device-fresh Data on its row; a padded row is dropped.

Per item, a batch runs the same kernels in the same order as a sequential
``launch()``, so results are bit for bit those of ``launch()``, except
where a library picks another algorithm for a larger batch: cuFFT may, so
the staged and fused modes of the MRI chain agree with ``launch()`` to
rtol 1e-6 on the card (the JAX package's caveat for its batched FFT).

A profiled stream (``profile=ProfileParameters(enable=True)``) records
the JAX package's phases, read once after the stream synchronised, with no
host wait and no timer thread inside the loop (:class:`_StreamPhases`):
``"transfer"`` for each batch placed from host items and
``"transfer_d2d"`` for a batch whose items all lie on the device (from
the host's start on the batch, its pack into the pinned buffer included,
to the copy stream's event behind its copies), ``"compute"`` for each
launch, ragged tails included (compute-stream events around it), and
``"compile"`` once for each batch row count whose twins this stream set
up, where the JAX package compiles (and counts a compile-cache miss): the
twins' ``init()`` plus the captures this stream made of them.

The JAX package's multi-device carves (``sharded=True``,
``split="proportional"``, ``lanes=True``; ``_SplitStack``, ``SplitBatch``,
``_UploadLanes``, per-device executables and completion timers) come with
the multi-GPU slice (``ROADMAP.md`` queue 1, item 6); here they raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .app import DataHandle
from . import process as _process
from .arena import ArenaLayout, batched_layout, pack_rows, unbatch_device, unpack_host
from .data import Data
from .process import ProfileParameters
from .sync import Coherence

MULTI_DEVICE = ("multi-device streaming (sharded=True, split='proportional', lanes=True) "
                "comes with the multi-GPU slice of the port (ROADMAP.md queue 1, item 6)")


def _refuse_multi_device(sharded: bool, split: str, lanes: bool) -> None:
    if split not in ("equal", "proportional"):
        raise ValueError(f"unknown split policy {split!r}: expected 'equal' | 'proportional'")
    if sharded or split == "proportional" or lanes:
        raise NotImplementedError(MULTI_DEVICE)


# ---------------------------------------------------------------------------
# streams and events
# ---------------------------------------------------------------------------

class _DeviceStreams:
    """The executor's stream and event operations on a CUDA device: copies
    on ``copy`` beside the compute stream (the current one), events
    between them.  :func:`_streams_for` gives None on the CPU, where every
    copy is synchronous.  The CPU tests put a recorder in its place."""

    def __init__(self, device: torch.device, copy: "torch.cuda.Stream"):
        self.device = device
        self.copy = copy

    def _compute(self) -> "torch.cuda.Stream":
        return torch.cuda.current_stream(self.device)

    def compute_event(self) -> "torch.cuda.Event":
        """An event behind everything queued on the compute stream so far."""
        ev = torch.cuda.Event()
        ev.record(self._compute())
        return ev

    def copy_event(self) -> "torch.cuda.Event":
        ev = torch.cuda.Event()
        ev.record(self.copy)
        return ev

    def copy_waits(self, ev) -> None:
        if ev is not None:
            self.copy.wait_event(ev)

    def copy_waits_compute(self) -> None:
        self.copy.wait_stream(self._compute())

    def compute_waits(self, ev) -> None:
        if ev is not None:
            self._compute().wait_event(ev)

    def host_waits(self, ev) -> None:
        if ev is not None:
            ev.synchronize()

    def on_copy(self):
        return torch.cuda.stream(self.copy)

    def upload(self, dev: torch.Tensor, host: torch.Tensor) -> None:
        """``dev`` <- ``host`` (pinned), asynchronously on the copy stream."""
        with self.on_copy():
            dev.copy_(host, non_blocking=True)

    def pinned(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def synchronize(self) -> None:
        self._compute().synchronize()


def _streams_for(device: torch.device, copy: Optional["torch.cuda.Stream"] = None):
    """The stream operations for ``device``: a :class:`_DeviceStreams` on a
    CUDA device (``copy`` or a new side stream), None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return _DeviceStreams(device, copy if copy is not None else torch.cuda.Stream(device))


def _host_buffer(streams, nbytes: int) -> torch.Tensor:
    """A staging buffer: pinned on a CUDA device, plain on the CPU."""
    if streams is not None:
        return streams.pinned(nbytes)
    return torch.empty(nbytes, dtype=torch.uint8)


class _StreamPhases:
    """A profiled stream's phase intervals (see the module docstring).

    Each interval's ends are host clock readings or, on a CUDA device,
    timing events, which :meth:`read` places on the host clock through one
    reference event that the host waited for before the stream began
    (``streams`` None: the CPU, where every copy and launch has run when
    the host reads the clock)."""

    def __init__(self, streams):
        self.streams = streams
        self.spans: List[Tuple[str, Any, Any]] = []
        if streams is not None:
            self._ref = self._event(streams.copy)
            self._ref.synchronize()
            self._host_ref = time.perf_counter()

    @staticmethod
    def _event(stream) -> "torch.cuda.Event":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def landed(self):
        """After an upload's copies: the copy stream's event, or the clock."""
        if self.streams is None:
            return time.perf_counter()
        return self._event(self.streams.copy)

    def launch_mark(self):
        """Before or after a launch: the compute stream's event, or the
        clock."""
        if self.streams is None:
            return time.perf_counter()
        return self._event(self.streams._compute())

    def _host_seconds(self, t) -> float:
        if isinstance(t, float):
            return t
        return self._host_ref + self._ref.elapsed_time(t) / 1e3

    def read(self, profile: ProfileParameters) -> None:
        """Record every interval into ``profile`` (the stream has
        synchronised; a failed event read raises)."""
        for phase, start, end in self.spans:
            profile.record_phase(phase, self._host_seconds(end) - self._host_seconds(start))
        self.spans = []


# ---------------------------------------------------------------------------
# the upload ring
# ---------------------------------------------------------------------------

class _Slot:
    """One upload destination: its device tensor, its host staging buffer
    (pinned on the card), the event behind the last launch that read the
    device tensor, and the event behind the last copy out of the buffer."""

    __slots__ = ("dev", "host", "read", "copied")

    def __init__(self, dev: torch.Tensor, host: torch.Tensor):
        self.dev = dev
        self.host = host
        self.read = None
        self.copied = None


class _Stack:
    """One streamed input's rows of one batch, before they are packed: per
    row, the item's host arrays (``{name -> array}``) or its device blob
    (of the item ``layout``); ``rows`` rows, the last item repeated as
    padding."""

    def __init__(self, edge: int, sources: Sequence[Any], rows: int, layout: ArenaLayout):
        self.edge = edge
        self.rows = rows
        self.layout = layout
        self.sources = _pad_rows(list(sources), rows)

    def pack(self, host: np.ndarray, layout: ArenaLayout) -> None:
        """Write the host rows into ``host`` (``layout``'s bytes); a device
        row keeps whatever it held until :meth:`copy_device_rows`."""
        pack_rows(host, layout, [None if isinstance(s, torch.Tensor) else s
                                 for s in self.sources])

    def copy_device_rows(self, dev: torch.Tensor, layout: ArenaLayout) -> None:
        """Copy the device rows' blobs into their rows of ``dev`` (the
        batched ``layout``), device to device, an entry at a time."""
        for e_b, e in zip(layout.entries, self.layout.entries):
            dst = dev[e_b.offset: e_b.offset + e_b.nbytes].view(self.rows, e.nbytes)
            for r, src in enumerate(self.sources):
                if isinstance(src, torch.Tensor):
                    dst[r].copy_(src[e.offset: e.offset + e.nbytes], non_blocking=True)

    @property
    def on_device(self) -> bool:
        return any(isinstance(s, torch.Tensor) for s in self.sources)

    @property
    def all_on_device(self) -> bool:
        """Every row a device blob: the JAX package stacks such a batch on
        the device (its ``"transfer_d2d"``)."""
        return all(isinstance(s, torch.Tensor) for s in self.sources)


class _HostArray:
    """A plain host array fed to a :class:`StreamQueue` of its own slots."""

    def __init__(self, array: Any):
        self.array = np.ascontiguousarray(array)

    @property
    def key(self) -> Tuple:
        return (self.array.shape, self.array.dtype.str)


class StreamQueue:
    """Bounded, double-buffered host->device feed over ``depth`` upload
    slots (see the module docstring).

    Iterating yields, for each item, the device tensor it was uploaded
    into (the slot's own, overwritten ``depth`` items later), with the
    current (compute) stream already ordered after the copy.  Asking for the next item marks the one handed out before as
    read by everything queued on the compute stream by then (the launch
    that consumed it), which frees its slot: the upload of item i +
    ``depth`` into that slot waits on that mark, on the device, and
    refilling the slot's pinned buffer waits (on the host) on the slot's
    last copy.  So ``depth`` counts the slots: item i in use and up to
    ``depth - 1`` later items in flight.

    Items are plain host arrays (the queue makes a slot of the array's
    shape and dtype per position in the ring) or, from the streaming
    executor, one input's :class:`_Stack` of a batch, whose slot
    ``target(stack, n)`` names: the twin's input blob of that batch.
    ``transfers`` counts the uploads issued; ``in_flight`` those not yet
    retired by :meth:`sync`.  ``phases`` (a profiled stream's
    :class:`_StreamPhases`) takes each upload's interval."""

    def __init__(self, items: Iterable[Any], device: Any = None, depth: int = 2, *,
                 target: Optional[Callable[[Any, int], Tuple[_Slot, ArenaLayout]]] = None,
                 streams: Any = None, phases: Optional[_StreamPhases] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._it = iter(items)
        self.device = torch.device(device if device is not None else "cpu")
        self.depth = depth
        self._streams = streams if streams is not None else _streams_for(self.device)
        self._target = target
        self._own: Dict[Tuple, _Slot] = {}
        self._fifo: deque = deque()
        self._held: Optional[_Slot] = None
        self._exhausted = False
        self._n = 0
        self.transfers = 0
        self._issued: List[Any] = []
        self._phases = phases

    def _slot_of(self, item: Any) -> Tuple[Any, _Slot, Optional[ArenaLayout]]:
        if self._target is not None and not isinstance(item, np.ndarray):
            slot, layout = self._target(item, self._n)
            return item, slot, layout
        item = _HostArray(item)
        key = item.key + (self._n % self.depth,)
        slot = self._own.get(key)
        if slot is None:
            a = item.array
            slot = _Slot(torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                                     device=self.device),
                         _host_buffer(self._streams, a.nbytes))
            self._own[key] = slot
        return item, slot, None

    def _dispatch(self, raw: Any) -> None:
        item, slot, layout = self._slot_of(raw)
        self._n += 1
        st = self._streams
        if st is not None:
            st.host_waits(slot.copied)          # the staging buffer's last copy landed
        t0 = time.perf_counter()
        host = slot.host.numpy()
        on_device = False
        if isinstance(item, _HostArray):
            host[...] = item.array.reshape(-1).view(np.uint8)
            dev = slot.dev.view(-1).view(torch.uint8)
        else:
            item.pack(host, layout)
            dev = slot.dev
            on_device = item.on_device
        if st is None:
            dev.copy_(slot.host)
            if on_device:
                item.copy_device_rows(slot.dev, layout)
        else:
            st.copy_waits(slot.read)            # the last launch that read the slot
            st.upload(dev, slot.host)
            if on_device:
                st.copy_waits_compute()         # device rows may still be being written
                with st.on_copy():
                    item.copy_device_rows(slot.dev, layout)
            slot.copied = st.copy_event()
            self._issued.append(slot.copied)
        if self._phases is not None:
            d2d = isinstance(item, _Stack) and item.all_on_device
            self._phases.spans.append(("transfer_d2d" if d2d else "transfer", t0,
                                       self._phases.landed()))
        self.transfers += 1
        self._fifo.append(slot)

    def _fill(self) -> None:
        while not self._exhausted and len(self._fifo) < self.depth:
            try:
                raw = next(self._it)
            except StopIteration:
                self._exhausted = True
                return
            self._dispatch(raw)

    def __iter__(self) -> "StreamQueue":
        return self

    def __next__(self) -> torch.Tensor:
        st = self._streams
        if self._held is not None:               # read by what was queued since
            self._held.read = st.compute_event() if st is not None else None
            self._held = None
        self._fill()
        if not self._fifo:
            raise StopIteration
        slot = self._fifo.popleft()
        if st is not None:
            st.compute_waits(slot.copied)
        self._held = slot
        return slot.dev

    @property
    def in_flight(self) -> int:
        """Uploads issued and not yet retired by :meth:`sync`."""
        return len(self._issued)

    def sync(self) -> None:
        """Explicit sync point: block until every issued upload landed."""
        if self._streams is not None:
            for ev in self._issued:
                self._streams.host_waits(ev)
        self._issued.clear()


# ---------------------------------------------------------------------------
# the launchable view and the batched twin
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Launchable:
    """What a stream needs of a process: its streamed inputs (names,
    handles, item layouts, in positional order), its static inputs and its
    output (the JAX package's ``PureLaunchable``, without the program)."""

    in_names: Tuple[str, ...]
    in_handles: Tuple[DataHandle, ...]
    in_layouts: Tuple[ArenaLayout, ...]
    aux_handles: Tuple[DataHandle, ...]
    out_handle: DataHandle
    out_layout: ArenaLayout

    @property
    def n_inputs(self) -> int:
        return len(self.in_names)

    @classmethod
    def of(cls, process) -> "_Launchable":
        app = process.getApp()

        def layout(h):
            d = app.getData(h)
            return d.layout or d.plan()
        streamed = process.stream_inputs()
        names = tuple(n for n, _ in streamed)
        handles = tuple(h for _, h in streamed)
        produced = set(process._produced_handles())
        aux: List[DataHandle] = []
        for h in process._graph_handles():
            if h not in handles and h not in produced and h not in aux:
                aux.append(h)
        return cls(in_names=names, in_handles=handles,
                   in_layouts=tuple(layout(h) for h in handles),
                   aux_handles=tuple(aux), out_handle=process.out_handle,
                   out_layout=layout(process.out_handle))


class BatchedProcess:
    """A process launched once for ``batch`` independent items: a twin of
    it (:meth:`~repro_torch.core.process.Process._twin`) on Data whose
    entries carry a leading ``batch`` axis, one for every streamed input
    and every Data the process writes; static inputs are read as they are.
    ``slots`` are the streamed inputs' upload slots (their device blobs are
    the twin's input blobs, their host buffers allocated here, pinned on
    the card).  Calling it launches the twin on whatever the input blobs
    hold and returns the outputs as a new ``(batch, out_total_bytes)``
    stack of item blobs.  ``captures``/``replays`` are the twin's."""

    def __init__(self, process, batch: int, *, streams: Any = None):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.process = process
        self.batch = batch
        self.streams = streams
        self.twin = None
        self.handles: Dict[DataHandle, DataHandle] = {}
        self.slots: List[_Slot] = []
        self.launches = 0
        self.init_seconds = 0.0

    def init(self) -> "BatchedProcess":
        t0 = time.perf_counter()
        p = self.process
        app = p.getApp()
        la = _Launchable.of(p)
        self.launchable = la
        for h in list(la.in_handles) + p._produced_handles():
            if h not in self.handles:
                d = app.getData(h)
                self.handles[h] = app.addData(
                    Data.from_layout(batched_layout(d.layout or d.plan(), self.batch)))
        self.twin = p._twin(self.handles)
        self.twin.init()
        self.slots = []
        for h in la.in_handles:
            dev = app.getData(self.handles[h]).device_blob
            self.slots.append(_Slot(dev, _host_buffer(self.streams, dev.numel())))
        self._out = app.getData(self.handles[la.out_handle])
        self.init_seconds = time.perf_counter() - t0
        return self

    def layout(self, edge: int) -> ArenaLayout:
        """The batched layout of streamed input ``edge``."""
        return self.process.getApp().getData(
            self.handles[self.launchable.in_handles[edge]]).layout

    @property
    def captures(self) -> int:
        return self.twin.captures

    @property
    def replays(self) -> int:
        return self.twin.replays

    def __call__(self) -> torch.Tensor:
        self.twin.launch()
        self.launches += 1
        return unbatch_device(self._out.device_blob, self._out.layout,
                              self.launchable.out_layout)

    def warmup(self) -> None:
        """Launch until the twin replays a graph (on the card: eager, then
        captured), on whatever its inputs hold; the result is dropped."""
        self()
        if (self.twin.graphed and self.twin._graph is None
                and _process._graphs_on(self.process.getApp().device)):
            self()

    def release(self) -> None:
        """Take the twin's Data out of the app."""
        app = self.process.getApp()
        for h in self.handles.values():
            app.delData(h)
        self.handles = {}
        self.slots = []


# ---------------------------------------------------------------------------
# the plan: twins per (rows, slot) and the ragged-tail policy
# ---------------------------------------------------------------------------

class _BatchPlan:
    """Twins + ragged-tail policy for one process (see the module
    docstring).  ``launch_rows(rows)`` decides how many rows a group of
    ``rows`` items is launched with; ``executable(rows, slot)`` is the twin
    for those rows in that upload slot (made once, kept on the process)."""

    def __init__(self, process, batch: int, *, depth: int = 2,
                 tail_waste_threshold: float = 0.5):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.process = process
        self.batch = batch
        self.depth = depth
        self.tail_waste_threshold = float(tail_waste_threshold)
        self.target = None
        self.launchable: Optional[_Launchable] = None
        self.streams = None
        self.phases: Optional[_StreamPhases] = None
        #: twins this plan set up for a row count the process had none of
        #: (where the JAX package compiles), by row count
        self.new_rows: Dict[int, List[BatchedProcess]] = {}

    def init(self) -> "_BatchPlan":
        self.target = self.process._stream_target()
        self._known_rows = {rows for rows, _ in self.target._stream_twins}
        app = self.target.getApp()
        self.device = app.device
        self.streams = _streams_for(app.device, app.copy_stream
                                    if app.device.type == "cuda" else None)
        self.launchable = _Launchable.of(self.target)
        self.precompile(self.batch)
        return self

    @property
    def twins(self) -> Dict[Tuple[int, int], BatchedProcess]:
        return self.target._stream_twins

    def launch_rows(self, rows: int) -> int:
        """Rows the batch of a ``rows``-item group carries."""
        if rows >= self.batch or rows < 1:
            return self.batch
        waste = (self.batch - rows) / self.batch
        if waste <= self.tail_waste_threshold:
            return self.batch                      # cheap enough: pad
        return rows                                # a twin of its own

    def executable(self, rows: int, slot: int = 0) -> BatchedProcess:
        bp = self.twins.get((rows, slot))
        if bp is None:
            bp = BatchedProcess(self.target, rows, streams=self.streams).init()
            self.twins[(rows, slot)] = bp
            if rows not in self._known_rows:
                self.new_rows.setdefault(rows, []).append(bp)
        return bp

    def compile_seconds(self) -> Dict[int, float]:
        """Per row count this plan set up: its twins' ``init()`` and the
        captures made of them so far."""
        return {rows: sum(bp.init_seconds + bp.twin.capture_seconds for bp in bps)
                for rows, bps in self.new_rows.items()}

    def precompile(self, rows: int) -> None:
        """Set up every twin a ``rows``-item group can be launched with
        (each upload slot) before the launch loop, so none is built inside
        it and stalls the double buffer."""
        rows = self.launch_rows(rows)
        for slot in range(self.depth):
            self.executable(rows, slot)

    def stack_group(self, items: Sequence[Tuple[Any, ...]]) -> List[_Stack]:
        """Per-input stacks of one row-aligned group (each item a per-input
        source tuple): ``launch_rows`` decides the row count for all of
        them, padding repeats the last item."""
        rows = self.launch_rows(len(items))
        return [_Stack(e, [it[e] for it in items], rows, lay)
                for e, lay in enumerate(self.launchable.in_layouts)]

    def slot(self, stack: _Stack, n: int) -> Tuple[_Slot, ArenaLayout]:
        """The upload slot of batch ``n``'s ``stack``: its twin's input."""
        bp = self.executable(stack.rows, n % self.depth)
        return bp.slots[stack.edge], bp.layout(stack.edge)

    def launch(self, rows: int, n: int, dev_blobs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Batch ``n``: launch its twin on the blobs its queues filled."""
        bp = self.executable(rows, n % self.depth)
        if any(d is not s.dev for d, s in zip(dev_blobs, bp.slots)):
            raise RuntimeError("stream queues are out of step with the batch plan")
        return bp()

    @staticmethod
    def split_output(out: torch.Tensor) -> List[torch.Tensor]:
        """Per-item output blobs (row views) of one launched batch."""
        return [out[r] for r in range(int(out.shape[0]))]

    def prepare_aux(self) -> None:
        """Upload every static input that has no device blob yet."""
        app = self.target.getApp()
        for h in self.launchable.aux_handles:
            if app.getData(h).device_blob is None:
                app.host2device(h)

    def run(self, groups: Iterator[List[Tuple[Any, ...]]]
            ) -> Iterator[Tuple[torch.Tensor, int]]:
        """Launch every group of ``groups`` (lists of per-input source
        tuples, at most ``batch`` items each), each input through its own
        :class:`StreamQueue` zipped row-aligned; yields each batch's output
        stack and its number of real (unpadded) items."""
        feed = _JoinFeed(self, groups)
        queues = [StreamQueue(feed.feed(e), self.device, self.depth, target=self.slot,
                              streams=self.streams, phases=self.phases)
                  for e in range(self.launchable.n_inputs)]
        ph = self.phases
        for n, dev_blobs in enumerate(zip(*queues)):  # batch n+1 uploads while n runs
            rows, k = feed.meta.popleft()
            start = ph.launch_mark() if ph is not None else None
            out = self.launch(rows, n, dev_blobs)
            if ph is not None:
                ph.spans.append(("compute", start, ph.launch_mark()))
            yield out, k

    def synchronize(self) -> None:
        """Block until everything queued on the compute stream ran."""
        if self.streams is not None:
            self.streams.synchronize()


# ---------------------------------------------------------------------------
# items: normalising, validating, grouping
# ---------------------------------------------------------------------------

def _host_blob_of(data: Data) -> "np.ndarray | torch.Tensor":
    """A packed host snapshot (numpy) of one input Data; a Data that lives
    only on the device (a streamed result) gives its device blob, so a
    stream of stream results never bounces through the host."""
    if data.layout is None:
        data.plan()
    if any(a.host is None for a in data):
        blob = data.device_blob
        if blob is not None and blob.ndim == 1:
            return blob
        data.sync_to_host()   # raises if there is no device copy either
    return data.pack_host()


def _source_of(data: Data) -> "Mapping[str, np.ndarray] | torch.Tensor":
    """What a stream packs of one input Data: its host arrays, read
    straight into their rows of the pinned buffer, or its device blob."""
    if data.layout is None:
        data.plan()
    if all(a.host is not None for a in data):
        return {a.name: a.host for a in data}
    return _host_blob_of(data)


def _stack_blobs(sources: Sequence[Any], layout: ArenaLayout) -> List[Any]:
    """Sources as :class:`_Stack` takes them: a packed host blob (numpy,
    ``layout``'s bytes) becomes its entries' views; host arrays and device
    blobs pass through."""
    out = []
    for s in sources:
        if isinstance(s, np.ndarray):
            if s.shape != (layout.total_bytes,) or s.dtype != np.uint8:
                raise ValueError(f"blob shape {s.shape}/{s.dtype} does not match the arena "
                                 f"layout ({layout.total_bytes},)/uint8")
            s = unpack_host(s, layout)
        elif isinstance(s, torch.Tensor) and tuple(s.shape) != (layout.total_bytes,):
            raise ValueError(f"device blob shape {tuple(s.shape)} does not match the arena "
                             f"layout ({layout.total_bytes},)")
        out.append(s)
    return out


def normalize_stream_item(item: Any, la: _Launchable, *,
                          what: str = "dataset") -> Tuple[Data, ...]:
    """One stream item -> one Data per streamed input, in ``la.in_names``
    order: a lone :class:`Data` (single-input processes), a ``{input name
    -> Data}`` mapping, or a positional tuple/list."""
    names = la.in_names
    if isinstance(item, Data):
        if la.n_inputs != 1:
            raise ValueError(
                f"{what} is a single Data but the process has {la.n_inputs} streaming "
                f"inputs {list(names)}; pass one Data per input edge as a mapping "
                "{name: Data} or a positional tuple")
        return (item,)
    if isinstance(item, Mapping):
        missing = [n for n in names if n not in item]
        extra = [n for n in item if n not in names]
        if missing or extra:
            raise ValueError(f"{what} mapping does not match the streaming inputs "
                             f"{list(names)}: missing {missing}, unknown {extra}")
        return tuple(item[n] for n in names)
    if isinstance(item, (tuple, list)):
        if len(item) != la.n_inputs:
            raise ValueError(f"{what} supplies {len(item)} Data for {la.n_inputs} "
                             f"streaming inputs {list(names)}")
        return tuple(item)
    raise TypeError(f"{what} must be a Data, a {{input name -> Data}} mapping, or a "
                    f"tuple (got {type(item).__name__})")


def _edge_blobs(item: Tuple[Data, ...], la: _Launchable, *, what: str = "dataset",
                names: Optional[Sequence[str]] = None, err: type = ValueError,
                pack: bool = False) -> Tuple[Any, ...]:
    """Per-input sources of one normalised item, each Data's layout checked
    against its input (a mismatch names the input).  ``pack=True`` takes a
    host snapshot of each (the server's admission, numpy only); otherwise
    the host arrays are read later, as the queue packs them."""
    out = []
    for name, layout, d in zip(names or la.in_names, la.in_layouts, item):
        if not isinstance(d, Data):
            raise err(f"{what} for input edge {name!r} is a {type(d).__name__}, not a Data")
        if d.layout is None:
            d.plan()
        if d.layout != layout:
            raise err(f"{what} layout for input edge {name!r} ({d.layout}) does not match "
                      f"the wired layout {layout}; all streamed Data sets must be "
                      "homogeneous per edge")
        out.append(_host_blob_of(d) if pack else _source_of(d))
    return tuple(out)


def _pad_rows(items: List[Any], rows: int) -> List[Any]:
    """Pad a group's sources to ``rows`` by repeating the last item (padded
    outputs are dropped downstream)."""
    return items + [items[-1]] * (rows - len(items))


class _JoinFeed:
    """Row-aligned per-input batch feeds sharing ONE group plan: each
    input's :meth:`feed` yields its :class:`_Stack` for exactly the same
    groups, stacked by :meth:`_BatchPlan.stack_group`, so row count and
    padding are decided once for all inputs.  ``meta`` holds, per formed
    group in order, its (rows, real items) for the consumer; a group's
    stacks are released once every input took them."""

    def __init__(self, plan: _BatchPlan, groups: Iterator[List[Tuple[Any, ...]]]):
        self.plan = plan
        self.n_edges = plan.launchable.n_inputs
        self._it = groups
        self._formed: List[Optional[List[_Stack]]] = []
        self._reads: List[int] = []
        self._done = False
        self.meta: deque = deque()

    def _ensure(self, pos: int) -> bool:
        while len(self._formed) <= pos and not self._done:
            try:
                items = next(self._it)
            except StopIteration:
                self._done = True
                return False
            layouts = self.plan.launchable.in_layouts
            items = list(zip(*[_stack_blobs([it[e] for it in items], layouts[e])
                               for e in range(self.n_edges)]))
            stacks = self.plan.stack_group(items)
            self._formed.append(stacks)
            self._reads.append(0)
            self.meta.append((stacks[0].rows, len(items)))
        return pos < len(self._formed)

    def feed(self, edge: int) -> Iterator[_Stack]:
        pos = 0
        while self._ensure(pos):
            stacked = self._formed[pos][edge]
            self._reads[pos] += 1
            if self._reads[pos] == self.n_edges:
                self._formed[pos] = None     # all inputs took it: release
            pos += 1
            yield stacked


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _result(layout: ArenaLayout, blob: torch.Tensor) -> Data:
    out = Data.from_layout(layout)
    out.device_blob = blob
    out.coherence = Coherence.DEVICE_FRESH
    return out


def stream_launch(process, datasets: Sequence[Any], *, batch: int = 1, depth: int = 2,
                  sync: bool = False, sharded: bool = False,
                  tail_waste_threshold: float = 0.5, split: str = "equal",
                  lanes: bool = False, profile: ProfileParameters | None = None) -> List[Data]:
    """Run ``datasets`` through ``process`` batched and double-buffered;
    see :meth:`repro_torch.core.process.Process.stream`."""
    _refuse_multi_device(sharded, split, lanes)
    datasets = list(datasets)
    if not datasets:
        return []
    plan = _BatchPlan(process, batch, depth=depth,
                      tail_waste_threshold=tail_waste_threshold).init()
    la = plan.launchable
    plan.prepare_aux()
    tail = len(datasets) % batch
    if tail:
        plan.precompile(tail)      # before the loop: never stalls the double buffer
    on = profile is not None and profile.enable
    if on:
        plan.phases = _StreamPhases(plan.streams)

    def groups() -> Iterator[List[Tuple[Any, ...]]]:
        buf: List[Tuple[Any, ...]] = []
        for i, d in enumerate(datasets):
            what = f"datasets[{i}]"
            buf.append(_edge_blobs(normalize_stream_item(d, la, what=what), la, what=what))
            if len(buf) == batch:
                yield buf
                buf = []
        if buf:
            yield buf

    t0 = time.perf_counter()
    rows: List[torch.Tensor] = []
    for out, k in plan.run(groups()):
        rows.extend(plan.split_output(out)[:k])
    results = [_result(la.out_layout, r) for r in rows]
    if sync:
        for r in results:
            r.sync_to_host()
    if on:
        plan.synchronize()
        profile.record(time.perf_counter() - t0)
        plan.phases.read(profile)
        for seconds in plan.compile_seconds().values():
            profile.record_phase("compile", seconds)
    return results
