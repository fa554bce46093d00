"""Backend choice for the ``use_kernel`` switch, the kernel chooser, and
the cost side of the roofline (the dry run's).

:func:`resolve_backend` holds the ``use_kernel`` switch against the device:
the hand-written CUDA kernel runs on CUDA tensors and the plain PyTorch
version on CPU tensors, whatever the switch says; a forced choice that
disagrees with the device raises.

:class:`KernelChooser` is the port of the JAX package's chooser as a
calibration tool: per (kernel, layout, device) it times the hand-written
kernel against the registry's plain version, takes the roofline bound from
the kernel's cost model (``kernel(name, cost=...)``; the JAX package reads
XLA's cost analysis) and the card's peak rates (:data:`CARD_PEAKS`), and
caches a :class:`KernelCalibration`.  The verdict uses the JAX package's
tie rule: within :data:`CALIBRATION_TIE_BAND` a memory-bound call goes to
the kernel and a compute-bound one to the plain version.

The knob stays ``True`` / ``False`` / ``"auto"``, with one deliberate
difference from the JAX package: ``"auto"`` does not ask the chooser.  On
the card it runs the hand-written kernel whatever the verdict: the plain
version serves nothing on the main path when a card is present, and a
kernel that is slower than its plain version stays and gets redesigned,
so a ``"plain"`` verdict on the card is a finding (``ROADMAP.md`` §2's
redesign queue), not a route.  Calibrating is explicit
(:meth:`KernelChooser.calibrate`, never inside a launch) and raises during
a CUDA-graph capture.  On the CPU the chooser records an untimed
``"plain"`` verdict, as the JAX package's does off the TPU, since the
hand-written kernels run only on CUDA tensors; the port has no interpret
mode, so it has no ``force_timing``.

The cost side (the JAX package's ``cost_dict``, collective parsers,
:class:`Roofline`, :func:`count_params`, :func:`model_flops`) reads what
:class:`CostMode` counts while a program runs, on ``meta`` tensors (the
dry run) or on real ones, where the JAX package reads a compiled XLA
program's cost analysis and HLO text:

    compute    = flops a card / the card's peak for the step's dtype
    memory     = bytes a card / HBM bandwidth
    collective = wire bytes a card / the link each mesh axis crosses

FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s (the products:
mm, bmm, convolutions, attention); bytes are each aten operation's input
and output bytes (XLA's "bytes accessed", for the port's unfused eager
operations); a registered kernel's call counts its registry ``Cost``
instead of its own operations.  Unlike XLA's cost analysis, which counts a
while loop's body once, a Python loop is counted every time it runs, so no
cost is reconstructed from unrolled variants.  Collective bytes are the
events the port's cross-lane operators record
(:mod:`repro_torch.models.parallel`) and the train step's data-axis
traffic (:func:`repro_torch.train.step.record_data_traffic`), each the
larger of a lane's input and output bytes, as the JAX package reads them
from HLO.  Every rate here is a data-sheet figure of the NVIDIA H100 SXM
(H100 80GB HBM3, 700 W) and its HGX board, not a measurement.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core import registry
from repro_torch.core.arena import tree_flatten

#: NVIDIA's data-sheet rates by a fragment of the name the card reports
#: (first match wins, so "H100" comes after its variants): memory bytes/s
#: and peak FLOP/s by the operations' type (dense, no sparsity).  The SXM
#: part reports "H100 80GB HBM3".
CARD_PEAKS = {
    "H100 PCIe": {"hbm_bytes_s": 2.0e12, "fp32": 51e12, "bf16_tensor": 756e12},
    "H100 NVL": {"hbm_bytes_s": 3.9e12, "fp32": 60e12, "bf16_tensor": 835e12},
    "H200": {"hbm_bytes_s": 4.8e12, "fp32": 67e12, "bf16_tensor": 989e12},
    "H100": {"hbm_bytes_s": 3.35e12, "fp32": 67e12, "bf16_tensor": 989e12},
}
#: the H100 SXM's: 3.35 TB/s HBM3, 67 TFLOP/s fp32, 989 TFLOP/s bf16 tensor
H100_PEAKS = CARD_PEAKS["H100"]

#: NVLink 4 between the 8 cards of an HGX H100 node: 450 GB/s a direction
#: a card (data sheet)
NVLINK_BYTES_S = 450e9
#: between nodes: one 400 Gb/s NDR InfiniBand port a card, 50 GB/s (data
#: sheet)
INFINIBAND_BYTES_S = 50e9
#: cards a node joins by NVLink
NODE_CARDS = 8

#: relative gap below which two measured times are a tie, broken by the
#: roofline bound: memory-bound -> the kernel, compute-bound -> plain
CALIBRATION_TIE_BAND = 0.10

#: cycles the card spins before each timed call, so that the host's enqueue
#: of the call is hidden behind it (about 1 ms at the H100's clocks)
_SPIN_CYCLES = 2_000_000

NO_KERNEL_ON_CPU = "the hand-written kernels run only on CUDA tensors"


@dataclasses.dataclass(frozen=True)
class KernelCalibration:
    """One (kernel, layout, device) verdict.  ``t_kernel_s`` / ``t_plain_s``
    are the min over the reps of one call's device time (``inf`` when not
    timed); ``t_compute_est_s`` / ``t_memory_est_s`` the roofline terms of
    the kernel's cost model at the card's peaks; ``bound`` the larger."""

    kernel: str
    layout: Any
    device: str
    backend: str                   # "kernel" | "plain"
    t_kernel_s: float
    t_plain_s: float
    t_compute_est_s: float
    t_memory_est_s: float
    bound: str                     # "compute" | "memory"
    timed: bool
    reason: str

    @property
    def use_kernel(self) -> bool:
        return self.backend == "kernel"

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the larger roofline term."""
        return max(self.t_compute_est_s, self.t_memory_est_s)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["layout"] = repr(self.layout)
        return d


_CALIBRATIONS: Dict[Tuple, KernelCalibration] = {}


def _tensors(args, kwargs) -> List[torch.Tensor]:
    """The tensor arguments, those inside a tuple or list too."""
    out: List[torch.Tensor] = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, (tuple, list)):
            out += _tensors(a, {})
        elif isinstance(a, torch.Tensor):
            out.append(a)
    return out


def _zeros(args, kwargs) -> Tuple[List[Any], Dict[str, Any]]:
    """The arguments with every tensor replaced by zeros of its layout."""
    def z(a):
        if isinstance(a, (tuple, list)):
            return type(a)(z(x) for x in a)
        return torch.zeros_like(a) if isinstance(a, torch.Tensor) else a
    return [z(a) for a in args], {k: z(v) for k, v in kwargs.items()}


def _layout_key(args, kwargs) -> Tuple:
    """Shapes and dtypes of the tensor arguments (dtype names as numpy
    spells them, the JAX package's key), literals by ``repr``."""
    def enc(a):
        if isinstance(a, torch.Tensor):
            return ("arr", tuple(a.shape), str(a.dtype).removeprefix("torch."))
        if isinstance(a, (tuple, list)):
            return ("seq", tuple(enc(x) for x in a))
        return ("lit", repr(a))
    return (tuple(enc(a) for a in args),
            tuple(sorted((k, enc(v)) for k, v in kwargs.items())))


def _device_of(args, kwargs) -> torch.device:
    devices = {t.device for t in _tensors(args, kwargs)}
    if len(devices) != 1:
        raise ValueError(f"a calibration needs its tensors on one device, got {sorted(map(str, devices))}")
    return devices.pop()


def _device_key(device: torch.device) -> str:
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    return f"cuda:{torch.cuda.get_device_name(index)}:{index}"


def card_peaks(card_name: str) -> Dict[str, float]:
    """The :data:`CARD_PEAKS` entry of the card that reports ``card_name``."""
    for fragment, peaks in CARD_PEAKS.items():
        if fragment in card_name:
            return peaks
    raise KeyError(f"no peak rates known for card {card_name!r}")


def kernel_cost(name: str, *args, **kwargs) -> registry.Cost:
    """The cost model's :class:`~repro_torch.core.registry.Cost` of one call
    of kernel ``name`` on these arguments."""
    entry = registry.KernelRegistry().entry(name)
    if entry.cost is None:
        raise KeyError(f"kernel {name!r} has no cost model")
    return entry.cost(*args, **kwargs)


def roofline_terms(name: str, *args, peaks: Dict[str, float] = H100_PEAKS,
                   **kwargs) -> Tuple[float, float]:
    """(compute seconds, memory seconds) of one call of kernel ``name`` on
    these arguments at ``peaks`` (the H100 SXM's by default), from its cost
    model."""
    cost = kernel_cost(name, *args, **kwargs)
    return cost.flops / peaks[cost.peak], cost.bytes / peaks["hbm_bytes_s"]


class KernelChooser:
    """Measured kernel-vs-plain verdicts per (kernel, layout, device); see
    the module docstring for what ``"auto"`` does with them."""

    def __init__(self, reps: int = 3):
        self.reps = reps

    # -- cached query ---------------------------------------------------------
    def lookup(self, name: str, *args, **kwargs) -> Optional[KernelCalibration]:
        return _CALIBRATIONS.get(self._key(name, args, kwargs))

    def records(self) -> List[KernelCalibration]:
        return list(_CALIBRATIONS.values())

    # -- calibration ----------------------------------------------------------
    def calibrate(self, name: str, *args, **kwargs) -> KernelCalibration:
        """Time the kernel and its plain version on zero-filled inputs of
        these arguments' layout (tensors give only shapes, dtypes and the
        device; other arguments are passed as they are) and cache the
        verdict.  On the card each call runs after the card spun for about
        a millisecond, so its time is its device time (a call that takes the
        host longer than that to enqueue, as a plain version of many small
        kernels may, includes the host's gaps); CUDA events, one warm-up,
        the min of ``reps``, warm L2; the bound at the card's
        :data:`CARD_PEAKS`.  On the CPU the verdict is untimed ``"plain"``.
        Raises during a CUDA-graph capture."""
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"calibrate({name!r}) during a CUDA-graph capture: "
                               "calibrating is explicit, never inside a launch")
        cached = self.lookup(name, *args, **kwargs)
        if cached is not None:
            return cached
        device = _device_of(args, kwargs)
        if device.type != "cuda":
            return self._untimed(name, args, kwargs)
        entry = registry.KernelRegistry().entry(name)
        if entry.ref is None:
            raise KeyError(f"kernel {name!r} has no plain version to choose from")
        t_compute, t_memory = roofline_terms(
            name, *args, peaks=card_peaks(torch.cuda.get_device_name(device)), **kwargs)
        bound = "memory" if t_memory >= t_compute else "compute"
        t_kernel = self._time(entry.fn, args, kwargs)
        t_plain = self._time(entry.ref, args, kwargs)
        if abs(t_kernel - t_plain) <= CALIBRATION_TIE_BAND * max(t_kernel, t_plain):
            backend = "kernel" if bound == "memory" else "plain"
            reason = f"measured tie (<{CALIBRATION_TIE_BAND:.0%}); roofline {bound}-bound"
        elif t_kernel < t_plain:
            backend, reason = "kernel", f"measured {t_plain / t_kernel:.2f}x faster"
        else:
            backend, reason = "plain", f"measured {t_kernel / t_plain:.2f}x faster"
        return self._store(name, args, kwargs, KernelCalibration(
            kernel=name, layout=_layout_key(args, kwargs), device=_device_key(device),
            backend=backend, t_kernel_s=t_kernel, t_plain_s=t_plain,
            t_compute_est_s=t_compute, t_memory_est_s=t_memory, bound=bound,
            timed=True, reason=reason))

    def _time(self, fn, args, kwargs) -> float:
        """Min over ``reps`` of one call's device time on zero-filled inputs,
        after a warm-up: CUDA events around the call, which runs after the
        card spun (see :meth:`calibrate`); the calls' kernel launches are
        not counted."""
        args, kwargs = _zeros(args, kwargs)
        best = float("inf")
        with registry.counting_into({}):
            fn(*args, **kwargs)                        # warm-up
            for _ in range(self.reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(_SPIN_CYCLES)
                start.record()
                fn(*args, **kwargs)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
        return best

    def _untimed(self, name, args, kwargs) -> KernelCalibration:
        """The CPU's verdict: plain, untimed and, as in the JAX package's
        untimed record, no roofline terms."""
        return self._store(name, args, kwargs, KernelCalibration(
            kernel=name, layout=_layout_key(args, kwargs),
            device=_device_key(_device_of(args, kwargs)), backend="plain",
            t_kernel_s=float("inf"), t_plain_s=float("inf"), t_compute_est_s=0.0,
            t_memory_est_s=0.0, bound="memory", timed=False, reason=NO_KERNEL_ON_CPU))

    @staticmethod
    def _key(name, args, kwargs) -> Tuple:
        return (name, _layout_key(args, kwargs), _device_key(_device_of(args, kwargs)))

    def _store(self, name, args, kwargs, rec: KernelCalibration) -> KernelCalibration:
        _CALIBRATIONS[self._key(name, args, kwargs)] = rec
        return rec


_DEFAULT_CHOOSER: Optional[KernelChooser] = None


def default_chooser() -> KernelChooser:
    global _DEFAULT_CHOOSER
    if _DEFAULT_CHOOSER is None:
        _DEFAULT_CHOOSER = KernelChooser()
    return _DEFAULT_CHOOSER


def resolve_backend(use_kernel: bool | str, name: str, *tensors: torch.Tensor) -> bool:
    """Whether kernel ``name``'s CUDA kernel runs on these tensors (else its
    plain version): the kernel on CUDA tensors, the plain version on CPU
    tensors.

    A forced choice must agree with the device: the kernel exists only on
    the card (``True`` with CPU tensors raises), and the plain version
    serves only the CPU (``False`` with CUDA tensors raises), so neither
    the card nor the kernel is ever bypassed silently.  ``"auto"`` follows
    the device and calibrates nothing (see the module docstring).  ``meta``
    tensors (shape inference) take the plain version.
    """
    if use_kernel not in (True, False, "auto"):
        raise ValueError(f"use_kernel={use_kernel!r}: expected True, False or 'auto'")
    kinds = {t.device.type for t in tensors}
    if kinds == {"meta"}:
        return False
    if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"{name}: tensors on mixed or unsupported devices: {sorted(kinds)}")
    on_cuda = kinds == {"cuda"}
    if use_kernel is True and not on_cuda:
        raise ValueError(f"use_kernel=True: the hand-written kernels ({name}) run only "
                         "on CUDA tensors; these lie on the CPU")
    if use_kernel is False and on_cuda:
        raise ValueError(f"use_kernel=False: the plain version of {name} serves only CPU "
                         "tensors; these lie on the card")
    return on_cuda


# ---------------------------------------------------------------------------
# The cost side: counting a program's work (the JAX package's cost_dict and
# HLO parsers), the roofline terms, and MODEL_FLOPS
# ---------------------------------------------------------------------------

#: factory operations that move no bytes (their outputs are uninitialised)
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "resize_"})


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Counter(TorchDispatchMode):
    """The dispatch half of :class:`CostMode`: each aten operation's bytes,
    and every new storage its outputs allocate."""

    def __init__(self, owner: "CostMode"):
        super().__init__()
        self.owner = owner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.owner._op(func, args, kwargs, out)
        return out


class CostMode:
    """Count the work of the program run inside it, on ``meta`` tensors (a
    dry run's trace) or on the CPU or the card (a real run of the same
    program, which counts the same):

    * flops: ``FlopCounterMode``'s count of the products, plus each
      registered kernel call's ``Cost`` (``kernels.common.traced``: the
      call's own operations are hidden);
    * bytes: each aten operation's input and output bytes (XLA's "bytes
      accessed"); views, in-place-free aliases and uninitialised factories
      move none; a kernel call its ``Cost``'s bytes;
    * memory: the peak of the bytes of the storages the program allocated
      and still holds (tensors made before the mode, such as the
      arguments, are not counted);
    * collectives: the events the cross-lane operators and the train
      step's data-axis traffic record while it is active (``events``:
      ``(kind, op name, bytes a lane, mesh axis)``).

    ``lanes`` (M) is the model group the program drives: work inside a
    cross-lane operator runs on the group's first lane (``home``), every
    other operation once a lane alike, so a lane's share (:meth:`per_lane`,
    the busiest lane's) is the lanes' work / M plus the home work; on
    ``meta`` tensors the lanes' devices cannot be told apart, which is why
    the split is by operator and not by device.  A counting mode is for
    one program at a time: the counts are the calling thread's (and its
    autograd device threads')."""

    def __init__(self, lanes: int = 1):
        self.lanes = lanes
        self.dispatch = _Counter(self)
        self.hidden = 0
        self._costing = False
        self.events: List[Tuple[str, str, int, str]] = []
        self.kernels: Dict[str, List[float]] = {}     # name -> [calls, flops, bytes]
        self._counts = {"lanes": [0.0, 0.0], "home": [0.0, 0.0]}
        self._live = {"lanes": 0, "home": 0}
        self._storages: Dict[int, Tuple[int, str]] = {}
        self.peak_bytes = 0                           # the group's live peak
        self.peak_lane_bytes = 0.0                    # a lane's share of it
        self._home = 0
        self._flops = None
        self._mark = 0
        self._stack: Optional[contextlib.ExitStack] = None

    # -- entering ---------------------------------------------------------------
    def __enter__(self) -> "CostMode":
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.models import parallel
        self._flops = FlopCounterMode(display=False)
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._flops)
        self._mark = 0
        self._stack.enter_context(self.dispatch)
        self._stack.enter_context(parallel.recording(self))
        registry.COST_MODES.append(self)
        return self

    def __exit__(self, *exc) -> None:
        self._flush()
        registry.COST_MODES.remove(self)
        self._stack.close()

    # -- the buckets --------------------------------------------------------------
    @property
    def _bucket(self) -> str:
        return "home" if self._home else "lanes"

    def _flush(self) -> None:
        """Give the products counted since the last flush to the current
        bucket (none inside a kernel call, whose ``Cost`` counts)."""
        if self._flops is None:
            return
        total = self._flops.get_total_flops()
        if not self.hidden:
            self._counts[self._bucket][0] += total - self._mark
        self._mark = total

    @contextlib.contextmanager
    def home(self) -> Iterator[None]:
        """Inside: work the group's first lane does for every lane (a
        cross-lane operator's sums and copies)."""
        self._flush()
        self._home += 1
        try:
            yield
        finally:
            self._flush()
            self._home -= 1

    @contextlib.contextmanager
    def kernel(self, name: str, cost_fn, args, kwargs) -> Iterator[None]:
        """Inside: one call of registered kernel ``name`` on ``args`` /
        ``kwargs``, counted as its cost model's ``Cost``."""
        self._flush()
        self.hidden += 1
        try:
            self._costing = True        # the cost model's own host tensors: not the program's
            try:
                cost = cost_fn(*args, **kwargs)
            finally:
                self._costing = False
            flops, moved = float(cost.flops), float(cost.bytes)
            tally = self.kernels.setdefault(name, [0, 0.0, 0.0])
            tally[0] += 1
            tally[1] += flops
            tally[2] += moved
            self._counts[self._bucket][0] += flops
            self._counts[self._bucket][1] += moved
            yield
        finally:
            self._flush()
            self.hidden -= 1

    def collective(self, kind: str, nbytes: int, name: str, axis: str) -> None:
        """Record one collective: ``nbytes`` a lane over mesh axis ``axis``."""
        self.events.append((kind, name, int(nbytes), axis))

    # -- the dispatch half ----------------------------------------------------------
    def _op(self, func, args, kwargs, out) -> None:
        if self._costing:
            return
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        seen = {_storage_key(t) for t in ins}
        fresh = [t for t in outs if _storage_key(t) not in seen]
        if not self.hidden and func.overloadpacket.__name__ not in _NO_TRAFFIC:
            if fresh or func._schema.is_mutable:
                self._counts[self._bucket][1] += float(sum(t.numel() * t.element_size()
                                                           for t in ins + outs))
        for t in fresh:
            self._allocated(t.untyped_storage())

    def _allocated(self, storage) -> None:
        key = storage._cdata
        if key in self._storages:
            return
        n, bucket = storage.nbytes(), self._bucket
        self._storages[key] = (n, bucket)
        self._live[bucket] += n
        weakref.finalize(storage, self._freed, key)
        self.peak_bytes = max(self.peak_bytes, self._live["lanes"] + self._live["home"])
        self.peak_lane_bytes = max(self.peak_lane_bytes,
                                   self._live["lanes"] / self.lanes + self._live["home"])

    def _freed(self, key: int) -> None:
        held = self._storages.pop(key, None)
        if held is not None:
            self._live[held[1]] -= held[0]

    # -- reading -------------------------------------------------------------------
    def total(self) -> Dict[str, float]:
        """The whole program's ``{"flops", "bytes accessed"}``."""
        self._flush()
        c = self._counts
        return {"flops": c["lanes"][0] + c["home"][0],
                "bytes accessed": c["lanes"][1] + c["home"][1]}

    def per_lane(self) -> Dict[str, float]:
        """The busiest lane's ``{"flops", "bytes accessed"}``: the lanes'
        work / M plus the first lane's own."""
        self._flush()
        c, m = self._counts, self.lanes
        return {"flops": c["lanes"][0] / m + c["home"][0],
                "bytes accessed": c["lanes"][1] / m + c["home"][1]}


def cost_dict(counted) -> Dict[str, float]:
    """The ``{"flops", "bytes accessed"}`` dict the JAX package's
    ``cost_dict`` gives: of a :class:`CostMode` (its whole program), or a
    dict of such metrics as it is (numeric entries only)."""
    if isinstance(counted, CostMode):
        return counted.total()
    return {k: float(v) for k, v in (counted or {}).items() if isinstance(v, (int, float))}


def collective_bytes(events) -> Dict[str, int]:
    """Bytes a lane by collective kind (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``) of recorded
    events (:attr:`CostMode.events`)."""
    out: Dict[str, int] = {}
    for kind, _, nbytes, *_ in events:
        out[kind] = out.get(kind, 0) + int(nbytes)
    return out


def collective_sources(events, top: int = 15) -> List[Tuple[str, str, int]]:
    """The top ``(kind, op name, bytes)`` of recorded events, summed by
    kind and op name (the last three calls inside ``repro_torch.models``
    that led to the operator, as the JAX package keeps the last three parts
    of an HLO ``op_name``)."""
    agg: Dict[Tuple[str, str], int] = {}
    for kind, name, nbytes, *_ in events:
        agg[(kind, name)] = agg.get((kind, name), 0) + int(nbytes)
    ranked = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    return [(k, n, b) for (k, n), b in ranked]


#: ring-algorithm wire multipliers: an all-reduce moves ~2x the tensor
#: (reduce-scatter + all-gather phases); the others move ~1x
WIRE_WEIGHT = {"all-reduce": 2.0}


def wire_bytes(breakdown: Dict[str, int]) -> float:
    return float(sum(WIRE_WEIGHT.get(k, 1.0) * v for k, v in breakdown.items()))


def link_bytes_s(span: int) -> float:
    """The rate of the slowest link a collective over ``span`` consecutive
    cards crosses: NVLink within a node of :data:`NODE_CARDS`, InfiniBand
    beyond it."""
    return NVLINK_BYTES_S if span <= NODE_CARDS else INFINIBAND_BYTES_S


def collective_seconds(events, spans: Dict[str, int]) -> float:
    """Seconds of the recorded collectives: each mesh axis's wire bytes at
    the rate of the link its groups cross (``spans``: axis -> cards from a
    group's first to its last)."""
    by_axis: Dict[str, Dict[str, int]] = {}
    for kind, _, nbytes, axis in events:
        by_axis.setdefault(axis, {})
        by_axis[axis][kind] = by_axis[axis].get(kind, 0) + int(nbytes)
    return sum(wire_bytes(b) / link_bytes_s(spans.get(axis, 1)) for axis, b in by_axis.items())


@dataclasses.dataclass
class Roofline:
    """The JAX package's roofline terms at the H100's data-sheet rates:
    the compute peak of the step's dtype (``peak``: a key of
    :data:`H100_PEAKS`), HBM3, and the links the collectives cross
    (``coll_s``, from :func:`collective_seconds`; None prices every wire
    byte at NVLink's rate)."""

    flops: float                   # a card's flops
    hbm_bytes: float               # a card's bytes accessed
    coll_bytes: float              # a card's collective WIRE bytes
    coll_breakdown: Dict[str, int]
    model_flops: float             # 6*N*D (train) or 2*N*D (inference), global
    peak: str = "bf16_tensor"
    coll_s: Optional[float] = None

    @property
    def peak_flops(self) -> float:
        return H100_PEAKS[self.peak]

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / H100_PEAKS["hbm_bytes_s"]

    @property
    def t_collective(self) -> float:
        return self.coll_s if self.coll_s is not None else self.coll_bytes / NVLINK_BYTES_S

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def useful_flops_ratio(self, n_chips: int) -> float:
        """MODEL_FLOPS / (a card's flops * cards)."""
        total = self.flops * n_chips
        return self.model_flops / total if total else float("nan")

    def mfu_bound(self, n_chips: int) -> float:
        """Model-FLOPs utilization ceiling implied by the dominant term."""
        if self.t_bound <= 0:
            return float("nan")
        return self.model_flops / (self.t_bound * n_chips * self.peak_flops)

    def to_dict(self, n_chips: int) -> Dict[str, Any]:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio(n_chips),
            "mfu_bound": self.mfu_bound(n_chips),
        }


def count_params(params_tree, cfg) -> Tuple[float, float]:
    """(total, active) parameter counts of a tree of tensors or
    :class:`~repro_torch.core.data.TensorSpec` leaves: an expert's
    ``w_gate`` / ``w_up`` / ``w_down`` counts ``top_k / n_experts`` of
    itself (a shared expert's whole), as in the JAX package."""
    total = active = 0.0
    for name, leaf in tree_flatten(params_tree):
        n = 1.0
        for d in tuple(leaf.shape):
            n *= int(d)
        total += n
        if cfg.n_experts and re.search(r"moe.*(w_gate|w_up|w_down)", name) \
                and "shared" not in name:
            active += n * cfg.top_k / cfg.n_experts
        else:
            active += n
    return total, active


def model_flops(cfg, params_tree, kind: str, batch: int, seq: int) -> float:
    """MODEL_FLOPS: 6 N D (train), 2 N D (prefill), 2 N a row (decode: one
    token), N the active parameters."""
    _, active = count_params(params_tree, cfg)
    if kind == "train":
        return 6.0 * active * batch * seq
    if kind == "prefill":
        return 2.0 * active * batch * seq
    return 2.0 * active * batch
