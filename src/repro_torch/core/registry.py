"""Kernel registry (paper §III-A.3a: automatic kernel loading, indexed by name).

OpenCLIPER compiles ``.cl`` sources at run time and indexes kernels by name.
Here kernel *modules* under :mod:`repro_torch.kernels` register their
wrappers with :func:`kernel`; :meth:`KernelRegistry.load` imports the
modules and, for a CUDA device, builds and loads the shared library of
hand-written kernels (the analogue of compiling the ``.cl`` files).  An
import or build failure surfaces as :class:`KernelCompileError` carrying
its log.

Each entry carries a plain-int launch count: a wrapper adds one where it
launches its CUDA kernel (and nowhere else), so a run can show that its
main path really went through the kernel.  While a process's launch is
captured into a CUDA graph (:meth:`repro_torch.core.process.Process.launch`),
nothing executes: the wrappers' counts go to that capture's own tally
(:func:`counting_into`), and each replay adds the tally to the counts
(:func:`add_launches`), so the counts stay the kernels that really ran;
a process's replay also counts a hit, and its capture a miss, of the
compiled launch's cache (:func:`graph_counts`).
A capture's tally (and :func:`also_counting`'s) belongs to the thread that
opened it: a launch in another thread meanwhile (a second replica on the
same card) counts as it would alone.  The one exception is a thread that
launches on the capture's own stream: autograd's device thread running a
captured backward, whose launches go to the tally of the capture on its
device.  The counts themselves are shared, and added to under a lock.

Each entry may carry a ``cost``: ``cost(*args, **kwargs)`` gives the
:class:`Cost` of one call on those arguments (only shapes and dtypes are
read), the roofline terms of :class:`repro_torch.launch.roofline.
KernelChooser`, where the JAX package reads XLA's cost analysis.  While a
counting mode (:class:`repro_torch.launch.roofline.CostMode`) is active, a
wrapper's call counts its entry's cost in place of its own operations
(:func:`counting_mode`, ``repro_torch.kernels.common.traced``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
import traceback
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple


class Cost(NamedTuple):
    """The work of one kernel call: floating-point operations, bytes moved
    (each input read once, each output written once) and the peak rate the
    operations are held to (a key of ``repro_torch.launch.roofline.
    CARD_PEAKS``: ``"fp32"`` or ``"bf16_tensor"``)."""

    flops: float
    bytes: float
    peak: str = "fp32"


@dataclasses.dataclass
class KernelEntry:
    name: str
    fn: Callable[..., Any]                    # the wrapper
    ref: Optional[Callable[..., Any]] = None  # plain PyTorch version
    module: str = ""
    launches: int = 0                         # CUDA launches since reset
    cost: Optional[Callable[..., Cost]] = None  # roofline terms of one call


class KernelCompileError(RuntimeError):
    """Raised when a kernel module fails to import or its sources fail to
    build; carries the build log."""

    def __init__(self, module: str, log: str):
        super().__init__(f"kernel module {module!r} failed to build:\n{log}")
        self.module = module
        self.log = log


_GLOBAL: Dict[str, KernelEntry] = {}
_COUNT_LOCK = threading.Lock()              # guards the launch counts
#: per thread: ``tally``, the capture in progress (if any), and ``also``, the
#: tallies that see every launch counted in this thread
_LOCAL = threading.local()
#: the tally of the capture in progress on each CUDA device, by index
_CAPTURING: Dict[int, Dict[str, int]] = {}


def _tally() -> Optional[Dict[str, int]]:
    tally = getattr(_LOCAL, "tally", None)
    if tally is None and _CAPTURING:
        import torch                        # only while a CUDA capture runs
        if torch.cuda.is_current_stream_capturing():
            tally = _CAPTURING.get(torch.cuda.current_device())
    return tally


def _also() -> List[Dict[str, int]]:
    also = getattr(_LOCAL, "also", None)
    if also is None:
        also = _LOCAL.also = []
    return also


def kernel(name: str, ref: Callable[..., Any] | None = None,
           cost: Callable[..., Cost] | None = None):
    """Decorator: register ``fn`` as a named kernel entry point, with its
    plain version ``ref`` and its ``cost`` model."""

    def deco(fn: Callable[..., Any]):
        _GLOBAL[name] = KernelEntry(name=name, fn=fn, ref=ref, module=fn.__module__,
                                    cost=cost)
        return fn

    return deco


def count_launch(name: str) -> None:
    """Add one to ``name``'s launch count (called by its wrapper right
    after a successful CUDA launch), or to the tally of the graph capture
    in progress."""
    tally = _tally()
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
        return
    with _COUNT_LOCK:
        _GLOBAL[name].launches += 1
    for t in _also():
        t[name] = t.get(name, 0) + 1


@contextlib.contextmanager
def counting_into(tally: Dict[str, int], device: Any = None) -> Iterator[None]:
    """Send the launches counted inside the block, in this thread, to
    ``tally`` instead of the launch counts (a graph capture, which runs
    nothing).  With the CUDA ``device`` of a capture, launches that
    another thread makes on a capturing stream of that device go there too
    (autograd's device thread, running the captured step's backward)."""
    outer = getattr(_LOCAL, "tally", None)
    _LOCAL.tally = tally
    key = None
    if device is not None and device.type == "cuda":
        if device.index is not None:
            key = device.index
        else:
            import torch
            key = torch.cuda.current_device()
        with _COUNT_LOCK:
            outer_dev = _CAPTURING.get(key)
            _CAPTURING[key] = tally
    try:
        yield
    finally:
        _LOCAL.tally = outer
        if key is not None:
            with _COUNT_LOCK:
                if outer_dev is None:
                    _CAPTURING.pop(key, None)
                else:
                    _CAPTURING[key] = outer_dev


@contextlib.contextmanager
def also_counting(tally: Dict[str, int]) -> Iterator[None]:
    """Add the launches that run inside the block in this thread (eager
    ones and replays) to ``tally`` as well as to the launch counts: the
    streaming executor counts each lane's launches so."""
    also = _also()
    also.append(tally)
    try:
        yield
    finally:
        for i in range(len(also) - 1, -1, -1):
            if also[i] is tally:            # by identity: tallies compare by value
                del also[i]
                break


#: process graph replays and captures: the compiled launch's cache hits and
#: misses (:func:`graph_counts`), guarded by ``_COUNT_LOCK``
_GRAPHS = {"hits": 0, "misses": 0}


def add_launches(tally: Dict[str, int], hit: int = 0) -> None:
    """Add a captured graph's tally to the launch counts (one replay), and
    ``hit`` to the graph hits under the same lock."""
    with _COUNT_LOCK:
        for name, n in tally.items():
            _GLOBAL[name].launches += n
        _GRAPHS["hits"] += hit
    for t in _also():
        for name, n in tally.items():
            t[name] = t.get(name, 0) + n


def count_capture() -> None:
    """One process graph capture: a miss."""
    with _COUNT_LOCK:
        _GRAPHS["misses"] += 1


def graph_counts() -> Tuple[int, int]:
    """``(hits, misses)``: process graph replays and captures."""
    with _COUNT_LOCK:
        return _GRAPHS["hits"], _GRAPHS["misses"]


#: the counting modes entered and not yet left, in any thread (outermost
#: first); empty, the wrappers' check costs one list read
COST_MODES: List[Any] = []


def counting_mode() -> Optional[Any]:
    """The innermost counting mode active in the calling thread (an
    autograd device thread runs under its caller's modes) that is not
    inside a kernel call it already counts, or None."""
    if not COST_MODES:
        return None
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    stack = _get_current_dispatch_mode_stack()
    for mode in reversed(COST_MODES):
        if any(m is mode.dispatch for m in stack):
            return None if mode.hidden else mode
    return None


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return {name: e.launches for name, e in sorted(_GLOBAL.items())}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for e in _GLOBAL.values():
            e.launches = 0


class KernelRegistry:
    """Per-app view over the global kernel table."""

    def __init__(self):
        self._loaded: Dict[str, KernelEntry] = {}

    def load(self, modules: str | Sequence[str], device=None) -> List[str]:
        """Import kernel modules and index their kernels (one call, many
        files — paper §III-A.3a).  ``modules`` are names relative to
        ``repro_torch.kernels`` (e.g. ``"coil_combine"``) or absolute dotted
        paths.  With a CUDA ``device`` the kernel library is built (once
        per source hash) and loaded here, so launches never compile."""
        if isinstance(modules, str):
            modules = [modules]
        added: List[str] = []
        for mod in modules:
            mod = mod.removesuffix(".cu").removesuffix(".py")
            qualified = mod if "." in mod else f"repro_torch.kernels.{mod}"
            try:
                importlib.import_module(qualified)
            except Exception:
                raise KernelCompileError(qualified, traceback.format_exc())
            for name, entry in _GLOBAL.items():
                if entry.module == qualified:
                    self._loaded.setdefault(name, entry)
                    if name not in added:
                        added.append(name)
        if device is not None and getattr(device, "type", device) == "cuda":
            from repro_torch.kernels import _build
            _build.library()
        return added

    def get(self, name: str) -> Callable[..., Any]:
        return self.entry(name).fn

    def ref(self, name: str) -> Callable[..., Any]:
        e = self.entry(name)
        if e.ref is None:
            raise KeyError(f"kernel {name!r} has no plain version")
        return e.ref

    def entry(self, name: str) -> KernelEntry:
        if name in self._loaded:
            return self._loaded[name]
        if name in _GLOBAL:  # registered by a direct import
            return _GLOBAL[name]
        raise KeyError(
            f"kernel {name!r} not loaded; available: {self.names}")

    @property
    def names(self) -> List[str]:
        return sorted(set(self._loaded) | set(_GLOBAL))
