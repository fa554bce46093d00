"""Backend choice for the ``use_kernel`` switch, and the kernel chooser.

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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import registry

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
