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

Multi-lane streams (``sharded=True``)
-------------------------------------

PyTorch drives several CUDA devices from one process, so the port keeps
the JAX package's single-controller API: ``CLapp().init()`` selects every
visible card and builds the ``("data", "model")`` mesh over them
(:mod:`repro_torch.launch.mesh`), one **lane** a card, and one call streams
over all of them.  Where the JAX package compiles one mesh-sharded program
(or one pinned program a device), the port gives each lane its own
:class:`_Lane`: an app on the lane's first device (its own Data registry),
that device's copy stream, and twins kept per ``(lane, rows, slot)``
(``Process._lane_twins``), each with its own CUDA graph on its device.
Each group of items is carved by a **split vector** (rows a lane), decided
once a group (:meth:`_BatchPlan.stack_group`), so every input of a join
shares it:

* ``sharded=True`` (the equal split): balanced rows a lane; the batch must
  be divisible by the number of lanes, and a ragged tail that is not pads;
* ``split="proportional"``: rows proportional to each lane's measured
  items/sec (``app.device_profiles``), balanced while any lane is cold or
  the batch is small, a lane measured or set at rate 0 excluded; each
  lane's launch is timed by two events on its compute stream, read once
  they completed (at the next group, or when the stream synchronises:
  :meth:`_BatchPlan.join_timers`), never by a host wait in the loop;
* ``lanes=True``: balanced rows a lane with no divisibility rule.

The equal split over a mesh that is the app's device alone is the
one-device stream (its twins are the ``(rows, slot)`` ones); the other two
carve over lanes even then, one lane on one card, as the JAX package runs
them through per-device executables.

Every carve uploads through :class:`_UploadLanes`: one pinned
:class:`StreamQueue` a lane and input, double-buffered on its own, whose
events are recorded and waited for on the lane's device.  A static input
(the maps) is copied into a replica on each lane's device once a stream
(:meth:`_BatchPlan.prepare_aux`), and a process's per-device constants
(the DFT tables) are built by each lane's twin in its ``init()``.  Each
item's result stays on the device that computed it.  On a 2D mesh a lane
is a model group: its twins are set up under the group's mesh, so
:func:`~repro_torch.launch.mesh.shard_by_logical` splits each item's
frames over the group.  A one-lane mesh of the app's device is the
single-device stream.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .app import DataHandle
from . import process as _process
from . import registry
from .arena import (ArenaLayout, batched_layout, carve_rows, pack_rows, unbatch_device,
                    unpack_host)
from .data import Data
from .process import ProfileParameters
from .sync import Coherence


def _check_policy(sharded: bool, split: str, lanes: bool) -> None:
    """The JAX package's checks of the carve options."""
    if split not in ("equal", "proportional"):
        raise ValueError(f"unknown split policy {split!r}: expected 'equal' | 'proportional'")
    if split == "proportional" and not sharded:
        raise ValueError("split='proportional' needs sharded=True: proportional batch carving "
                         "distributes work over the app mesh's data-axis lanes")
    if lanes and not sharded:
        raise ValueError("lanes=True needs sharded=True: per-lane upload lanes carve each "
                         "batch over the app mesh's data-axis lanes")


def _on(device: torch.device):
    """Make ``device`` the current CUDA device for the block, when it is a
    CUDA device and not the current one already."""
    if device.type != "cuda" or device.index is None or \
            torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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
        """An event behind everything queued on the compute stream so far
        (recorded, as every event of this device, under the device)."""
        ev = torch.cuda.Event()
        with _on(self.device):
            ev.record(self._compute())
        return ev

    def copy_event(self) -> "torch.cuda.Event":
        ev = torch.cuda.Event()
        with _on(self.device):
            ev.record(self.copy)
        return ev

    def copy_waits(self, ev) -> None:
        if ev is not None:
            with _on(self.device):
                self.copy.wait_event(ev)

    def copy_waits_compute(self) -> None:
        with _on(self.device):
            self.copy.wait_stream(self._compute())

    def compute_waits(self, ev) -> None:
        if ev is not None:
            with _on(self.device):
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


def _mark(streams, on_copy: bool = False):
    """Now, as one end of a timed span: the host clock on the CPU
    (``streams`` None, where every copy and launch has run when the host
    reads it), else a timing event recorded on the device's compute (or
    copy) stream, with its device."""
    if streams is None:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    with _on(streams.device):
        ev.record(streams.copy if on_copy else streams._compute())
    return ev, streams.device


class _StreamPhases:
    """A profiled stream's phase intervals (see the module docstring).

    Each interval's ends are :func:`_mark` s, which :meth:`read` places on
    the host clock through a reference event of their device that the host
    waited for before the stream began (one for each device of
    ``streams``, the stream operations of the plan and its lanes)."""

    def __init__(self, streams: Sequence[Any]):
        self.spans: List[Tuple[str, Any, Any]] = []
        self._refs: Dict[torch.device, Tuple[Any, float]] = {}
        for st in streams:
            if st is not None and st.device not in self._refs:
                ref, _ = _mark(st, on_copy=True)
                ref.synchronize()
                self._refs[st.device] = (ref, time.perf_counter())

    def _host_seconds(self, t) -> float:
        if isinstance(t, float):
            return t
        ev, device = t
        ref, host_ref = self._refs[device]
        return host_ref + ref.elapsed_time(ev) / 1e3

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
        #: rows a lane, decided once for the group (multi-lane streams)
        self.split: Optional[Tuple[int, ...]] = None
        self._parts: Optional[List[Optional["_Stack"]]] = None

    def carve(self) -> List[Optional["_Stack"]]:
        """This stack cut by :attr:`split`: lane ``j``'s rows as a stack of
        their own (None for a lane given no rows), sharing the sources (no
        array is copied)."""
        if self._parts is None:
            self._parts = [None if not c else _Stack(self.edge, rows, c, self.layout)
                           for c, rows in zip(self.split, carve_rows(self.sources, self.split))]
        return self._parts

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
    ``device`` may be a :class:`~repro_torch.launch.mesh.Placement` (its
    device is used).
    ``transfers`` counts the uploads issued; ``in_flight`` those not yet
    retired by :meth:`sync`.  ``phases`` (a profiled stream's
    :class:`_StreamPhases`) takes each upload's interval."""

    def __init__(self, items: Iterable[Any], device: Any = None, depth: int = 2, *,
                 target: Optional[Callable[[Any, int], Tuple[_Slot, ArenaLayout]]] = None,
                 streams: Any = None, phases: Optional[_StreamPhases] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._it = iter(items)
        device = getattr(device, "device", device)          # a Placement's device
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
                                       _mark(st, on_copy=True)))
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

    def retire(self) -> None:
        """Mark the item handed out last as read by everything queued on
        the compute stream by now (the launch that consumed it)."""
        if self._held is not None:
            st = self._streams
            self._held.read = st.compute_event() if st is not None else None
            self._held = None

    def __next__(self) -> torch.Tensor:
        self.retire()                            # read by what was queued since
        st = self._streams
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


class _Lane:
    """One lane of a multi-lane stream: row ``index`` of the app mesh, a
    model group whose first device holds the lane's Data.  ``app`` is the
    lane's own app (:meth:`~repro_torch.core.app.CLapp._lane_app`: the
    group's mesh, its own Data registry, the root app's kernels and copy
    streams), ``streams`` the stream operations of its device (None on the
    CPU) and ``replicas`` its copies of the static inputs, by the root
    app's handle.  Lanes are kept on the root app by ``key`` = (index,
    group), so twins of one key always meet the same lane app."""

    def __init__(self, index: int, group: Sequence[torch.device], root):
        self.index = index
        self.group = tuple(torch.device(d) for d in group)
        self.device = self.group[0]
        self.key = (index, tuple(str(d) for d in self.group))
        self.app = root._lane_app(self.group)
        self.streams = _streams_for(self.device, root.copy_stream_for(self.device)
                                    if self.device.type == "cuda" else None)
        self.replicas: Dict[DataHandle, DataHandle] = {}

    def replica(self, root, h: DataHandle) -> DataHandle:
        """The lane's Data for the root app's static input ``h``: the same
        layout, its blob on the lane's device (filled by :meth:`refresh`)."""
        d = root.getData(h)
        layout = d.layout or d.plan()
        rh = self.replicas.get(h)
        if rh is None or self.app.getData(rh).layout != layout:
            rh = self.replicas[h] = self.app.addData(Data.from_layout(layout))
        return rh

    def refresh(self, root, h: DataHandle) -> None:
        """Copy the root Data's blob into the lane's replica, device to
        device, on the lane device's compute stream (the replica keeps its
        address, so the lane's graphs read the new values)."""
        src = root.getData(h).device_blob
        dst = self.app.getData(self.replica(root, h)).device_blob
        with _on(self.device):
            dst.copy_(src, non_blocking=True)


def _lanes_of(app, groups: Sequence[Sequence[torch.device]]) -> List[_Lane]:
    """The app's lanes for the given model groups (made once a key)."""
    lanes = []
    for j, group in enumerate(groups):
        key = (j, tuple(str(torch.device(d)) for d in group))
        lane = app._stream_lanes.get(key)
        if lane is None:
            lane = app._stream_lanes[key] = _Lane(j, group, app)
        lanes.append(lane)
    return lanes


class SplitBatch:
    """The outputs of one carved group: ``parts[i]``, a ``(counts[i],
    out_total_bytes)`` stack of item blobs on lane ``lanes[i]``'s device
    (lanes given no rows are left out); the parts in order are the items
    in stream order."""

    __slots__ = ("parts", "counts", "lanes")

    def __init__(self, parts: Sequence[torch.Tensor], counts: Sequence[int],
                 lanes: Sequence[int]):
        self.parts = tuple(parts)
        self.counts = tuple(int(c) for c in counts)
        self.lanes = tuple(lanes)

    @property
    def shape(self) -> Tuple[int, int]:
        return (sum(self.counts), int(self.parts[0].shape[1]))


class BatchedProcess:
    """A process launched once for ``batch`` independent items: a twin of
    it (:meth:`~repro_torch.core.process.Process._twin`) on Data whose
    entries carry a leading ``batch`` axis, one for every streamed input
    and every Data the process writes; static inputs are read as they are.
    ``slots`` are the streamed inputs' upload slots (their device blobs are
    the twin's input blobs, their host buffers allocated here, pinned on
    the card).  Calling it launches the twin on whatever the input blobs
    hold and returns the outputs as a new ``(batch, out_total_bytes)``
    stack of item blobs.  ``captures``/``replays`` are the twin's, and
    ``kernel_launches`` counts the kernels its launches ran.

    ``device=`` or ``group=`` (a model group) puts the twin on a lane of
    its own: its Data on that device, static inputs replicated there
    (``lane.refresh``), set up under the group's mesh so annotated
    processes split their frames over the group; a one-device group is
    ``device=``.  ``sharded=True`` instead makes one twin a lane of the
    app mesh, ``batch / lanes`` rows each (``parts``); ``batch`` must be
    divisible by the number of lanes, and ``batch_sharding`` is the app
    mesh's data-axis placement.  The three are mutually exclusive, as in
    the JAX package."""

    def __init__(self, process, batch: int, *, streams: Any = None, sharded: bool = False,
                 device: Optional[torch.device] = None,
                 group: Optional[Sequence[torch.device]] = None, lane: Optional[_Lane] = None):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if group is not None and len(group) == 1:
            device, group = group[0], None       # a one-device group: pin plain
        if sharded and (device is not None or group is not None):
            raise ValueError("sharded=True and device=/group= are mutually exclusive (a pinned "
                             "twin spans one device group)")
        if device is not None and group is not None:
            raise ValueError("device= and group= are mutually exclusive")
        self.process = process
        self.batch = batch
        self.streams = streams
        self.sharded = sharded
        self.device = torch.device(device) if device is not None else None
        self.group = tuple(group) if group is not None else None
        self.lane = lane
        self.batch_sharding = None
        self.parts: List["BatchedProcess"] = []
        self.twin = None
        self.handles: Dict[DataHandle, DataHandle] = {}
        self._owned: List[DataHandle] = []
        self.slots: List[_Slot] = []
        self.launches = 0
        self.init_seconds = 0.0
        self.kernel_launches: Dict[str, int] = {}

    def init(self) -> "BatchedProcess":
        t0 = time.perf_counter()
        p = self.process
        root = p.getApp()
        if self.sharded:
            return self._init_sharded(root)
        if self.lane is None and (self.device is not None or self.group is not None):
            group = tuple(self.group or (self.device,))
            groups = list(root.mesh.groups) if root.mesh is not None else []
            self.lane = (_lanes_of(root, groups)[groups.index(group)] if group in groups
                         else _Lane(-1, group, root))
        if self.lane is not None:
            self.streams = self.lane.streams
            self.batch_sharding = _mesh_placement(self.lane.group)
        home = root if self.lane is None else self.lane.app
        la = _Launchable.of(p)
        self.launchable = la
        for h in list(la.in_handles) + p._produced_handles():
            if h not in self.handles:
                d = root.getData(h)
                self.handles[h] = home.addData(
                    Data.from_layout(batched_layout(d.layout or d.plan(), self.batch)))
                self._owned.append(self.handles[h])
        if self.lane is not None:
            for h in la.aux_handles:
                self.handles[h] = self.lane.replica(root, h)
                if root.getData(h).device_blob is not None:
                    self.lane.refresh(root, h)
        self.twin = p._twin(self.handles, app=home if self.lane is not None else None)
        self.twin.init()
        self.slots = []
        for h in la.in_handles:
            dev = home.getData(self.handles[h]).device_blob
            self.slots.append(_Slot(dev, _host_buffer(self.streams, dev.numel())))
        self._out = home.getData(self.handles[la.out_handle])
        self.init_seconds = time.perf_counter() - t0
        return self

    def _init_sharded(self, root) -> "BatchedProcess":
        lanes = _lanes_of(root, root.mesh.groups)
        if self.batch % len(lanes):
            raise ValueError(
                f"batch={self.batch} not divisible by the mesh data-axis size {len(lanes)}; "
                "pick batch as a multiple of the lane count so every lane gets whole items")
        self.batch_sharding = root.data_sharding(("data",))
        self.parts = [BatchedProcess(self.process, self.batch // len(lanes), lane=lane).init()
                      for lane in lanes]
        self.launchable = self.parts[0].launchable
        self.slots = [s for bp in self.parts for s in bp.slots]
        return self

    def layout(self, edge: int) -> ArenaLayout:
        """The batched layout of streamed input ``edge``."""
        return self._home.getData(self.handles[self.launchable.in_handles[edge]]).layout

    @property
    def _home(self):
        return self.lane.app if self.lane is not None else self.process.getApp()

    @property
    def captures(self) -> int:
        if self.parts:
            return sum(bp.captures for bp in self.parts)
        return self.twin.captures

    @property
    def replays(self) -> int:
        if self.parts:
            return sum(bp.replays for bp in self.parts)
        return self.twin.replays

    def __call__(self) -> Any:
        if self.parts:          # sharded: one launch a lane, its rows on its device
            outs = [bp() for bp in self.parts]
            self.launches += 1
            return SplitBatch(outs, [bp.batch for bp in self.parts],
                              [bp.lane.index for bp in self.parts])
        with registry.also_counting(self.kernel_launches):
            if self.lane is not None:
                with _on(self.lane.device):
                    self.twin.launch()
            else:
                self.twin.launch()
        self.launches += 1
        return unbatch_device(self._out.device_blob, self._out.layout,
                              self.launchable.out_layout)

    def warmup(self) -> None:
        """Launch until the twin replays a graph (on the card: eager, then
        captured), on whatever its inputs hold; the result is dropped."""
        self()
        twin_app = self.twin.getApp() if self.twin is not None else None
        if (twin_app is not None and self.twin.graphed and self.twin._graph is None
                and _process._graphs_on(twin_app.device) and _process._one_device(twin_app.mesh)):
            self()

    def release(self) -> None:
        """Take the twin's Data out of its app (a lane's replicas stay)."""
        for bp in self.parts:
            bp.release()
        app = self._home
        for h in self._owned:
            app.delData(h)
        self.handles, self._owned = {}, []
        self.slots = []


def _mesh_placement(group: Sequence[torch.device]):
    """The placement of a lane's uploads and replicas: its group,
    replicated (the JAX package's ``lane_sharding``)."""
    from repro_torch.launch.mesh import group_sharding, pinned_sharding
    return pinned_sharding(group[0]) if len(group) == 1 else group_sharding(group)


# ---------------------------------------------------------------------------
# the plan: twins per (lane, rows, slot), the ragged-tail and split policies
# ---------------------------------------------------------------------------

class _BatchPlan:
    """Twins + ragged-tail policy + split policy for one process (see the
    module docstring).  ``launch_rows(rows)`` decides how many rows a group
    of ``rows`` items is launched with; ``executable(rows, slot, lane)`` is
    the twin for those rows in that upload slot (made once, kept on the
    process).  With ``sharded=True`` over a mesh of more than the app's
    device, ``lanes`` holds the mesh's :class:`_Lane` s and every group is
    carved by :meth:`split_vector`."""

    def __init__(self, process, batch: int, *, depth: int = 2,
                 tail_waste_threshold: float = 0.5, sharded: bool = False,
                 split: str = "equal", lanes: bool = False):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        _check_policy(sharded, split, lanes)
        self.process = process
        self.batch = batch
        self.depth = depth
        self.tail_waste_threshold = float(tail_waste_threshold)
        self.sharded = sharded
        self.split = split
        self.lane_uploads = lanes
        self.target = None
        self.launchable: Optional[_Launchable] = None
        self.streams = None
        self.phases: Optional[_StreamPhases] = None
        self.lanes: List[_Lane] = []
        #: twins this plan set up for a row count the process had none of
        #: (where the JAX package compiles), by row count
        self.new_rows: Dict[int, List[BatchedProcess]] = {}
        #: the split vectors of the groups this plan formed, in order
        self.vectors: List[Tuple[int, ...]] = []

    @property
    def proportional(self) -> bool:
        return self.split == "proportional"

    @property
    def per_lane(self) -> bool:
        """Whether groups are carved over lanes (else the one-device path)."""
        return bool(self.lanes)

    def init(self) -> "_BatchPlan":
        self.target = self.process._stream_target()
        app = self.target.getApp()
        self.app = app
        self.device = app.device
        mesh = app.mesh
        if self.sharded and mesh is None:
            raise RuntimeError("sharded streaming needs the app mesh (CLapp.init builds one "
                               "over the selected devices)")
        # the equal split over the app's device alone is the one-device stream;
        # a proportional split or upload lanes always carve over lanes (the
        # JAX package's per-device executables), one lane on a one-card mesh
        if self.sharded and (mesh.groups != ((app.device,),) or self.proportional
                             or self.lane_uploads):
            self.lanes = _lanes_of(app, mesh.groups)
            if not (self.proportional or self.lane_uploads) and self.batch % len(self.lanes):
                raise ValueError(
                    f"batch={self.batch} not divisible by the mesh data-axis size "
                    f"{len(self.lanes)}; pick batch as a multiple of the lane count so every "
                    "lane gets whole items (or stream with lanes=True or "
                    "split='proportional', which carve uneven rows)")
        self._known_rows = ({rows for _, rows, _ in self.target._lane_twins} if self.per_lane
                            else {rows for rows, _ in self.target._stream_twins})
        self.streams = _streams_for(app.device, app.copy_stream
                                    if app.device.type == "cuda" else None)
        self.launchable = _Launchable.of(self.target)
        self.precompile(self.batch)
        return self

    @property
    def twins(self) -> Dict[Tuple[int, int], BatchedProcess]:
        return self.target._stream_twins

    @property
    def registry(self):
        return self.app.device_profiles

    def launch_rows(self, rows: int) -> int:
        """Rows the batch of a ``rows``-item group carries."""
        if rows >= self.batch or rows < 1:
            return self.batch
        waste = (self.batch - rows) / self.batch
        if waste <= self.tail_waste_threshold:
            return self.batch                      # cheap enough: pad
        if self.per_lane and not (self.proportional or self.lane_uploads) \
                and rows % len(self.lanes):
            return self.batch                      # the equal split: whole items a lane
        return rows                                # a twin of its own

    def executable(self, rows: int, slot: int = 0,
                   lane: Optional[_Lane] = None) -> BatchedProcess:
        """The twin for ``rows`` rows in upload ``slot``, on ``lane`` (None:
        the app's device)."""
        twins = self.twins if lane is None else self.target._lane_twins
        key = (rows, slot) if lane is None else (lane.key, rows, slot)
        bp = twins.get(key)
        if bp is None:
            bp = BatchedProcess(self.target, rows, streams=self.streams, lane=lane).init()
            twins[key] = bp
            if rows not in self._known_rows:
                self.new_rows.setdefault(rows, []).append(bp)
        return bp

    def compile_seconds(self) -> Dict[int, float]:
        """Per row count this plan set up: its twins' ``init()`` and the
        captures made of them so far."""
        return {rows: sum(bp.init_seconds + bp.twin.capture_seconds for bp in bps)
                for rows, bps in self.new_rows.items()}

    def split_vector(self, rows: int) -> Tuple[int, ...]:
        """Rows a lane for one ``rows``-row group: measured-proportional when
        the registry is warm, else balanced over the lanes not measured or
        set at rate 0 (over every lane when all are).  The equal split and
        ``lanes=True`` always balance over every lane."""
        from repro_torch.launch.mesh import DeviceProfileRegistry
        n = len(self.lanes)
        if not self.proportional:
            return DeviceProfileRegistry.balanced(rows, n)
        vec = self.registry.split(rows, range(n))
        if vec is not None:
            return vec
        rates = self.registry.rates(range(n))
        usable = [j for j, r in enumerate(rates) if r != 0] or list(range(n))  # nan: usable
        out = [0] * n
        for j, c in zip(usable, DeviceProfileRegistry.balanced(rows, len(usable))):
            out[j] = c
        return tuple(out)

    def twins_for(self, rows: int) -> List[BatchedProcess]:
        """Every twin a ``rows``-row launch can use, in each upload slot:
        the app device's, or each lane's for the balanced vector and the
        current split vector (a later vector may need more, made lazily)."""
        if not self.per_lane:
            return [self.executable(rows, slot) for slot in range(self.depth)]
        from repro_torch.launch.mesh import DeviceProfileRegistry
        vectors = {DeviceProfileRegistry.balanced(rows, len(self.lanes)),
                   self.split_vector(rows)}
        return [self.executable(c, slot, lane)
                for vec in sorted(vectors) for lane, c in zip(self.lanes, vec) if c
                for slot in range(self.depth)]

    def precompile(self, rows: int) -> None:
        """Set up every twin a ``rows``-item group can be launched with
        before the launch loop, so none is built inside it and stalls the
        double buffer (under a proportional split a vector that shifted
        since may still need one, made at its first use)."""
        self.twins_for(self.launch_rows(rows))

    def stack_group(self, items: Sequence[Tuple[Any, ...]]) -> List[_Stack]:
        """Per-input stacks of one row-aligned group (each item a per-input
        source tuple): ``launch_rows`` decides the row count for all of
        them, padding repeats the last item.  On lanes the split vector is
        decided here too, once for the group: every input carries it."""
        rows = self.launch_rows(len(items))
        stacks = [_Stack(e, [it[e] for it in items], rows, lay)
                  for e, lay in enumerate(self.launchable.in_layouts)]
        if self.per_lane:
            if self.proportional:
                self.harvest()         # the rates of launches that completed so far
            vec = self.split_vector(rows)
            self.vectors.append(vec)
            for st in stacks:
                st.split = vec
        return stacks

    def slot(self, stack: _Stack, n: int, lane: Optional[_Lane] = None
             ) -> Tuple[_Slot, ArenaLayout]:
        """The upload slot of batch ``n``'s ``stack`` (on ``lane``): its
        twin's input."""
        bp = self.executable(stack.rows, n % self.depth, lane)
        return bp.slots[stack.edge], bp.layout(stack.edge)

    def launch(self, rows: int, n: int, dev_blobs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Batch ``n``: launch its twin on the blobs its queues filled."""
        bp = self.executable(rows, n % self.depth)
        if any(d is not s.dev for d, s in zip(dev_blobs, bp.slots)):
            raise RuntimeError("stream queues are out of step with the batch plan")
        return bp()

    def launch_lanes(self, edge_parts: Sequence[List[Tuple[int, int, torch.Tensor]]]
                     ) -> SplitBatch:
        """One carved group: each lane given rows launches its twin on the
        blobs its queues filled, the launches timed by events on the
        lane's compute stream (the host clock on the CPU) for the registry
        (:meth:`harvest`) and a profiled stream's ``"compute"``."""
        timed = self.proportional or self.phases is not None
        outs, counts, lanes = [], [], []
        for i, (j, c, _) in enumerate(edge_parts[0]):
            lane = self.lanes[j]
            n = self._lane_n[j]
            self._lane_n[j] += 1
            bp = self.executable(c, n % self.depth, lane)
            if any(parts[i][2] is not s.dev for parts, s in zip(edge_parts, bp.slots)):
                raise RuntimeError("stream queues are out of step with the batch plan")
            start = _mark(lane.streams) if timed else None
            outs.append(bp())
            if timed:
                end = _mark(lane.streams)
                if self.proportional:
                    self.app._pending_rates.append((j, c, start, end))
                if self.phases is not None:
                    self.phases.spans.append(("compute", start, end))
            counts.append(c)
            lanes.append(j)
        return SplitBatch(outs, counts, lanes)

    def harvest(self, block: bool = False) -> None:
        """Record into the registry the rate of every timed lane launch
        whose end event completed (``block``: wait for each); the rest
        stay pending."""
        pending, keep = self.app._pending_rates, []
        for j, c, start, end in pending:
            if isinstance(end, float):
                self.registry.record(j, c, end - start)
                continue
            ev, device = end
            if block:
                ev.synchronize()
            elif not ev.query():
                keep.append((j, c, start, end))
                continue
            self.registry.record(j, c, start[0].elapsed_time(ev) / 1e3)
        self.app._pending_rates = keep

    def join_timers(self) -> None:
        """Wait for the timed launches still pending and record them (the
        registry then holds every rate of this stream)."""
        self.harvest(block=True)

    @staticmethod
    def split_output(out: Any) -> List[torch.Tensor]:
        """Per-item output blobs (row views) of one launched batch, in item
        order."""
        if isinstance(out, SplitBatch):
            return [part[r] for part in out.parts for r in range(int(part.shape[0]))]
        return [out[r] for r in range(int(out.shape[0]))]

    def prepare_aux(self) -> None:
        """Upload every static input that has no device blob yet, and copy
        each into its replica on every lane (once a stream, never inside a
        launch)."""
        app = self.target.getApp()
        for h in self.launchable.aux_handles:
            if app.getData(h).device_blob is None:
                app.host2device(h)
            for lane in self.lanes:
                lane.refresh(app, h)

    def run(self, groups: Iterator[List[Tuple[Any, ...]]]
            ) -> Iterator[Tuple[Any, int]]:
        """Launch every group of ``groups`` (lists of per-input source
        tuples, at most ``batch`` items each), each input through its own
        :class:`StreamQueue` (a lane: its own :class:`_UploadLanes`) zipped
        row-aligned; yields each batch's output stack (a
        :class:`SplitBatch` on lanes) and its number of real (unpadded)
        items."""
        feed = _JoinFeed(self, groups)
        ph = self.phases
        if self.per_lane:
            self._lane_n = [0] * len(self.lanes)
            queues: List[Any] = [_UploadLanes(self, feed.feed(e), self.depth, ph)
                                 for e in range(self.launchable.n_inputs)]
            for parts in zip(*queues):             # batch n+1 uploads while n runs
                rows, k = feed.meta.popleft()
                yield self.launch_lanes(parts), k
            return
        queues = [StreamQueue(feed.feed(e), self.device, self.depth, target=self.slot,
                              streams=self.streams, phases=ph)
                  for e in range(self.launchable.n_inputs)]
        for n, dev_blobs in enumerate(zip(*queues)):  # batch n+1 uploads while n runs
            rows, k = feed.meta.popleft()
            start = _mark(self.streams) if ph is not None else None
            out = self.launch(rows, n, dev_blobs)
            if ph is not None:
                ph.spans.append(("compute", start, _mark(self.streams)))
            yield out, k

    def every_streams(self) -> List[Any]:
        """The stream operations of the app's device and of every lane."""
        return [self.streams] + [lane.streams for lane in self.lanes]

    def synchronize(self) -> None:
        """Block until everything queued on the compute streams ran."""
        done = set()
        for st in self.every_streams():
            if st is not None and id(st) not in done:
                done.add(id(st))
                st.synchronize()

    def lane_launches(self) -> Dict[int, Dict[str, int]]:
        """Kernel launches of each lane's twins of this process, by lane
        index (counted since the twins were made)."""
        out: Dict[int, Dict[str, int]] = {}
        for (key, _, _), bp in self.target._lane_twins.items():
            tally = out.setdefault(key[0], {})
            for name, n in bp.kernel_launches.items():
                tally[name] = tally.get(name, 0) + n
        return out


class _Fanout:
    """Lockstep tee of one iterator into ``n`` branches.  Items are
    buffered only while some branch still needs them: the head is released
    once EVERY branch has consumed it."""

    def __init__(self, it: Iterator[Any], n: int):
        self._it = iter(it)
        self._buf: deque = deque()
        self._base = 0              # absolute stream index of _buf[0]
        self._pos = [0] * n         # absolute per-branch read positions
        self._done = False

    def branch(self, j: int) -> Iterator[Any]:
        while True:
            idx = self._pos[j]
            while idx - self._base >= len(self._buf):
                if self._done:
                    return
                try:
                    self._buf.append(next(self._it))
                except StopIteration:
                    self._done = True
                    return
            item = self._buf[idx - self._base]
            self._pos[j] = idx + 1
            while self._buf and self._base < min(self._pos):
                self._buf.popleft()       # every branch is past the head
                self._base += 1
            yield item


class _UploadLanes:
    """Per-lane double-buffered upload queues for ONE input.

    The input's feed of carved :class:`_Stack` groups is teed across one
    pinned :class:`StreamQueue` a lane: lane ``j``'s queue uploads its
    rows of each group that gives it any (:meth:`_Stack.carve`) into its
    own twins' slots on its device, on its device's copy stream, so each
    lane's upload is issued and double-buffered on its own.  ``__next__``
    zips the heads of the lanes given rows back into one group: a list of
    ``(lane, rows, device blob)``.  Quacks like :class:`StreamQueue` where
    the plan cares: iteration and ``sync()``."""

    def __init__(self, plan: _BatchPlan, feed: Iterator[_Stack], depth: int = 2,
                 phases: Optional[_StreamPhases] = None):
        lanes = plan.lanes
        if not lanes:
            raise RuntimeError("_UploadLanes needs a plan carved over lanes")
        fan = _Fanout(feed, len(lanes) + 1)   # one more branch reads the split vectors

        def lane_rows(j: int) -> Iterator[_Stack]:
            for st in fan.branch(j):
                part = st.carve()[j]
                if part is not None:
                    yield part

        def target(lane: _Lane):
            return lambda stack, n: plan.slot(stack, n, lane)

        self._lanes = [StreamQueue(lane_rows(j), lane.device, depth, target=target(lane),
                                   streams=lane.streams, phases=phases)
                       for j, lane in enumerate(lanes)]
        self._splits = fan.branch(len(lanes))

    def __iter__(self) -> "_UploadLanes":
        return self

    def __next__(self) -> List[Tuple[int, int, torch.Tensor]]:
        try:
            st = next(self._splits)
        except StopIteration:
            for q in self._lanes:               # the last launches read their slots
                q.retire()
            raise
        return [(j, c, next(self._lanes[j])) for j, c in enumerate(st.split) if c]

    @property
    def transfers(self) -> int:
        return sum(q.transfers for q in self._lanes)

    def sync(self) -> None:
        for q in self._lanes:
            q.sync()


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
    _check_policy(sharded, split, lanes)
    datasets = list(datasets)
    if not datasets:
        return []
    plan = _BatchPlan(process, batch, depth=depth, tail_waste_threshold=tail_waste_threshold,
                      sharded=sharded, split=split, lanes=lanes).init()
    la = plan.launchable
    plan.prepare_aux()
    tail = len(datasets) % batch
    if tail:
        plan.precompile(tail)      # before the loop: never stalls the double buffer
    on = profile is not None and profile.enable
    if on:
        plan.phases = _StreamPhases(plan.every_streams())

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
    if plan.proportional:
        # results read back: every rate can be read; else only those ready
        plan.harvest(block=sync or on)
    if plan.per_lane:
        plan.target.split_vectors = plan.vectors
    return results
