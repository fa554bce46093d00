"""Process — the paper's algorithm abstraction (§III-A.3b, §III-B).

A Process is an operator: typed input/output **ports**, launch parameters,
and :meth:`Process.apply`, which maps named tensor views of the input
arena(s) to named output tensors.  Every port other than ``"out"`` is an
input; the primary ``"in"`` comes first, and a secondary input (such
as ``smaps``) reaches :meth:`apply` through its ``aux`` argument under its
port name.

The paper's two key properties:

* **init/launch split** — :meth:`Process.init` does all the one-time work:
  arena layouts, port checks, building and loading the kernels, output and
  scratch allocation, and whatever a subclass precomputes (the IDFT
  twiddle tables of the fused reconstruction).  :meth:`Process.launch` only
  executes: it reads zero-copy views of the arena blobs, runs ``apply`` and
  writes the result into the output arena, allocating nothing but the
  kernels' outputs.  On a CUDA app the launch is compiled, as the JAX
  package's ``aot_compile`` compiles it: the second launch after
  ``init()`` captures the launch into one CUDA graph (:func:`capture_graph`)
  and every later launch replays it, one host call for all its kernels.
* **zero-copy chaining** — a stage's output handle doubling as the next
  stage's input handle moves no bytes.  ``apply`` receives views of the
  output arena as ``out``; a kernel that writes there directly (in place,
  when the output Data is also the input) leaves nothing to copy.

:class:`ProcessChain` composes processes.  ``mode="staged"`` launches each
stage on its own, every stage writing its output arena, as the paper does;
``mode="fused"`` runs the stages' ``apply`` back to back on tensors, so
only the last stage writes an arena and the intermediates never land in
one.

In-place safety: a process initialised with its output handle equal to one
of its input handles refuses to launch after the handles were re-wired
apart without a new ``init()`` (:class:`DonatedBufferError`), as the
reference does for a donated buffer.

Streaming (:meth:`Process.stream`, :mod:`repro_torch.core.stream`) runs
many independent Data sets through a process, a batch of them a launch:
a **twin** of the process (:meth:`Process._twin`) is wired onto Data
whose entries carry one more leading axis, and launched as any process
is.  A class whose ``apply`` takes that axis sets :attr:`Process.
batch_axis`; an input bound with :meth:`Process.set_aux_handle` is
static and reaches every item of a batch unbatched.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import registry, trace
from .app import CLapp, DataHandle, INVALID_HANDLE
from .arena import is_bfloat16, pack_device, spec_dtype, torch_dtype
from .data import TensorSpec


@dataclasses.dataclass
class ProfileParameters:
    """Collects per-launch times when enabled (paper's profiling argument).

    On a CUDA device a sample is the time between two ``torch.cuda.Event``
    records on the compute stream around the launch; on the CPU it is the
    host clock.  Statistics return ``nan`` when nothing was recorded.

    ``phases`` are named buckets beside the samples, with the JAX
    package's names: ``"transfer"`` (host to device uploads),
    ``"transfer_d2d"`` (a streamed batch already on the device),
    ``"compute"`` (a launch, or each stage of a staged chain) and
    ``"compile"`` (a stream's set-up of a new batch row count).  Phases
    overlap by design: they say where the time went and do not partition
    the samples.
    """

    enable: bool = False
    samples: List[float] = dataclasses.field(default_factory=list)
    phases: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def record(self, seconds: float) -> None:
        if self.enable:
            self.samples.append(seconds)

    def record_phase(self, phase: str, seconds: float) -> None:
        if self.enable:
            self.phases.setdefault(phase, []).append(seconds)

    def phase_total(self, phase: str) -> float:
        """Seconds recorded under ``phase`` (0.0 when it never ran)."""
        return float(sum(self.phases.get(phase, ())))

    def phase_totals(self) -> Dict[str, float]:
        """``{phase -> total seconds}`` over every recorded bucket."""
        return {k: self.phase_total(k) for k in self.phases}

    def mean(self) -> float:
        if not self.samples:
            return float("nan")
        return float(sum(self.samples) / len(self.samples))

    def percentile(self, p: float) -> float:
        if not self.samples:
            return float("nan")
        return float(np.percentile(np.asarray(self.samples), p))

    def p50(self) -> float:
        return self.percentile(50.0)

    def p99(self) -> float:
        return self.percentile(99.0)


@dataclasses.dataclass
class _PhaseView:
    """Phase-only view of a profile: :meth:`record_phase` forwards,
    :meth:`record` is dropped.  ``LMServer`` launches its cache splices and
    slot releases with one, so their phases count as the JAX package's do
    while the samples stay one a prefill and one a decode step."""

    parent: ProfileParameters

    @property
    def enable(self) -> bool:
        return self.parent.enable

    def record(self, seconds: float) -> None:
        pass

    def record_phase(self, phase: str, seconds: float) -> None:
        self.parent.record_phase(phase, seconds)


class _HostEvent:
    """The CPU's stand-in for a timing event: the host clock when recorded
    (the CPU's work has run by then)."""

    t = float("nan")

    def record(self, stream=None) -> None:
        self.t = time.perf_counter()

    def query(self) -> bool:
        return True

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3

    def synchronize(self) -> None:
        pass


class _Phases:
    """The phase intervals of one profiled launch, as (phase, start, end)
    event pairs read once the launch has run (:meth:`read`).

    On a CUDA device the events are timing ``torch.cuda.Event`` s: a
    stage's on the compute stream, an upload's on the copy stream around
    the pinned copy.  ``external=True`` makes events that a CUDA-graph
    capture records as nodes of the graph (``cudaEventRecordExternal``),
    so every replay records them again.  On the CPU they are host clock
    readings (:class:`_HostEvent`)."""

    def __init__(self, device: torch.device, external: bool = False):
        self.cuda = device.type == "cuda"
        self.external = external
        self.spans: List[Tuple[str, Any, Any]] = []
        self._upload: Optional[List[Any]] = None

    def event(self):
        if self.cuda:
            return torch.cuda.Event(enable_timing=True, external=self.external)
        return _HostEvent()

    def mark(self, stream=None):
        """An event recorded now on ``stream`` (the current one)."""
        ev = self.event()
        ev.record(stream) if stream is not None else ev.record()
        return ev

    def uploaded(self, start, end) -> None:
        """One upload's events: a launch's uploads make one ``"transfer"``
        span, from the first one's start to the last one's end."""
        if self._upload is None:
            self._upload = [start, end]
        else:
            self._upload[1] = end

    def end_transfers(self) -> None:
        """Close the launch's ``"transfer"`` span, if it uploaded."""
        if self._upload is not None:
            self.spans.append(("transfer", *self._upload))
            self._upload = None

    def read(self, profile) -> None:
        """Record every span's seconds into ``profile`` (the events have
        completed: the launch's end was waited for).  A failed read
        raises."""
        for phase, start, end in self.spans:
            end.synchronize()
            profile.record_phase(phase, start.elapsed_time(end) / 1e3)
        self.spans = []


class _Timer:
    """Device-aware interval: CUDA events on the device's current stream,
    else the host clock."""

    def __init__(self, device: torch.device):
        self._stream = (torch.cuda.current_stream(device)
                        if device.type == "cuda" else None)
        if self._stream is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self._stream)
        else:
            self._t0 = time.perf_counter()

    def seconds(self) -> float:
        if self._stream is None:
            return time.perf_counter() - self._t0
        end = torch.cuda.Event(enable_timing=True)
        end.record(self._stream)
        end.synchronize()
        return self._start.elapsed_time(end) / 1e3


#: guards the two per-device tables below
_STATE_LOCK = threading.Lock()


def compile_cache_stats() -> Tuple[int, int]:
    """``(hits, misses)`` of the compiled launch, summed over every
    process: a hit is a graph replay, a miss a capture (the JAX package
    counts its AOT compile cache's), read from the registry's counts
    (:func:`~repro_torch.core.registry.graph_counts`).  A CPU app
    compiles nothing."""
    return registry.graph_counts()


#: a side stream a CUDA device that captures run on (``torch.cuda.graph``'s
#: default is one stream, made on whichever device captured first)
_CAPTURE_STREAMS: Dict[torch.device, Any] = {}
#: one lock a CUDA device, held across each capture on it
_CAPTURE_LOCKS: Dict[torch.device, threading.Lock] = {}


def capture_graph(body: Callable[[], None], device: torch.device) -> Callable[[], None]:
    """Capture ``body`` (one launch's device work) into a CUDA graph on
    ``device``, on that device's own capture stream, and return its
    replay.  Capturing records the kernels and runs none of them.  The
    compiled launch's one seam: the CPU tests put a recorder here.

    Several threads may launch on one device (the replicas of a
    :class:`~repro_torch.serve.control.FrontDoor` on one card): the
    capture runs in ``"thread_local"`` error mode, so another thread's
    eager launches, allocations and stream synchronizations carry on
    during it (the default ``"global"`` mode fails them, or the capture),
    and the device's lock keeps two captures, and the device-wide
    synchronize and ``empty_cache`` that ``torch.cuda.graph`` does before
    one, from overlapping.  In one thread the captures are those of the
    global mode."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        key = torch.device("cuda", torch.cuda.current_device())
        with _STATE_LOCK:
            lock = _CAPTURE_LOCKS.setdefault(key, threading.Lock())
            stream = _CAPTURE_STREAMS.get(key)
            if stream is None:
                stream = _CAPTURE_STREAMS[key] = torch.cuda.Stream(key)
        with lock, torch.cuda.graph(graph, stream=stream,
                                    capture_error_mode="thread_local"):
            body()
    return graph.replay


def _graphs_on(device: torch.device) -> bool:
    """Whether a launch on ``device`` is compiled (on a CUDA device)."""
    return device.type == "cuda"


#: the mesh of the launch in progress in this thread (None outside one):
#: what ``repro_torch.launch.mesh.shard_by_logical`` partitions over, so
#: one annotated ``apply`` body runs whole in a lane's twin on a 1D mesh
#: and split over its model group in a group's twin (the JAX package's
#: ``current_compile_mesh``, the mesh of the AOT lowering in progress).
#: Thread-local: two threads that launch at once (two replicas behind a
#: FrontDoor) each read their own launch's mesh.
_COMPILE_MESH = threading.local()


def current_compile_mesh():
    """The mesh of the launch in progress in this thread (None outside
    one)."""
    return getattr(_COMPILE_MESH, "mesh", None)


@contextlib.contextmanager
def _compiling_under(mesh) -> Any:
    prev = getattr(_COMPILE_MESH, "mesh", None)
    _COMPILE_MESH.mesh = mesh
    try:
        yield
    finally:
        _COMPILE_MESH.mesh = prev


def _one_device(mesh) -> bool:
    """Whether the pieces of a launch under ``mesh`` all run on one device
    (its first model group names one device): only then is the launch
    captured into a CUDA graph, which records the work of one device."""
    return mesh is None or len(set(mesh.groups[0])) == 1


@dataclasses.dataclass
class _Graph:
    """A captured launch: its replay, the blobs it was captured on, and
    the kernel launches one replay makes."""

    replay: Callable[[], None]
    key: Tuple
    launches: Dict[str, int]
    #: a staged chain's per-stage ``"compute"`` events, recorded by every
    #: replay (a graph captured for a profiled launch; else empty)
    spans: List[Tuple[str, Any, Any]] = dataclasses.field(default_factory=list)


def out_view(out: Optional[Dict[str, torch.Tensor]], name: str,
             dtype: torch.dtype, shape) -> Optional[torch.Tensor]:
    """The output arena's view ``name`` when a kernel can write a result of
    ``dtype`` and ``shape`` straight into it, else None."""
    v = None if out is None else out.get(name)
    if v is None or v.dtype != dtype or tuple(v.shape) != tuple(shape):
        return None
    return v


class PortError(TypeError):
    """A Data set does not satisfy a Process port declaration.  Raised by
    ``init()``, before anything is built or launched."""


@dataclasses.dataclass(frozen=True)
class Port:
    """Typed declaration of one Process input or output.

    ``"in"`` and ``"out"`` are the primary input and output; any other
    entry is an additional input keyed by its own name.  ``dtype`` may be a
    concrete dtype or a numpy kind such as ``np.complexfloating``."""

    optional: bool = False
    names: Optional[Tuple[str, ...]] = None  # NDArray names the Data must hold
    dtype: Any = None
    ndim: Optional[int] = None
    doc: str = ""

    def __post_init__(self):
        if self.names is not None:
            object.__setattr__(self, "names", tuple(self.names))

    def validate(self, specs: Mapping[str, TensorSpec], *,
                 owner: str = "?", port: str = "?", lead: int = 0) -> None:
        """Check ``{array name -> TensorSpec}`` against this port; ``lead``
        leading (batch) axes more than ``ndim`` are allowed."""
        where = f"{owner}.ports[{port!r}]"
        if self.names:
            missing = [n for n in self.names if n not in specs]
            if missing:
                raise PortError(f"{where}: Data is missing required arrays "
                                f"{missing} (got {sorted(specs)})")
        for name in (self.names or tuple(specs)):
            s = specs[name]
            # bfloat16 has no numpy dtype: it passes wherever float16 would
            kind = np.float16 if is_bfloat16(s.dtype) else s.dtype
            if self.dtype is not None and not np.issubdtype(kind, self.dtype):
                raise PortError(f"{where}: array {name!r} has dtype {s.dtype}, "
                                f"expected {self.dtype}")
            if self.ndim is not None and len(s.shape) != self.ndim + lead:
                raise PortError(f"{where}: array {name!r} has shape "
                                f"{tuple(s.shape)} (ndim {len(s.shape)}), "
                                f"expected ndim {self.ndim + lead}")


class DonatedBufferError(RuntimeError):
    """A process initialised in place (its output Data is one of its
    inputs) was launched after its handles were re-wired apart.  Call
    ``init()`` again for the new wiring."""


class Process:
    """Base class for operators.  Subclasses implement :meth:`apply`,
    declare their wiring contract in :attr:`ports`, and may extend
    :meth:`init` with their own one-time work.

    ``captures`` and ``replays`` count the CUDA graphs this process
    captured and the launches that replayed one (:meth:`launch`);
    ``capture_seconds`` is the host time its captures took."""

    #: kernel modules this process needs (built and loaded in init)
    kernel_names: Sequence[str] = ()

    #: whether a launch on the card is compiled into a CUDA graph; a class
    #: whose launches rarely repeat on one wiring sets it False
    graphed: bool = True

    #: whether ``apply`` takes one more leading (batch) axis on every
    #: streamed input and the output, as a batch of items (:meth:`stream`);
    #: streaming a class that does not raises
    batch_axis: bool = False

    ports: Dict[str, Port] = {"in": Port(), "out": Port()}

    def __init__(self, app: Optional[CLapp] = None):
        self._app = app
        self.in_handles: Dict[str, DataHandle] = {"in": INVALID_HANDLE}
        self.out_handle: DataHandle = INVALID_HANDLE
        self.launch_params: Any = None
        self._in_names: Tuple[str, ...] = ()
        self._in_place_name: Optional[str] = None
        self._initialized = False
        self._legacy_warned = False
        #: captured launches: [False] unprofiled, [True] a staged chain's
        #: profiled launch, whose graph also records each stage's events
        self._graphs: Dict[bool, _Graph] = {}
        self._warm = False          # launched eagerly since init / the last drop
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0
        #: inputs bound with :meth:`set_aux_handle`: static, not streamed
        self.aux_names: set = set()
        self._batched: frozenset = frozenset()   # a twin's batched handles
        #: a stream's twins of this process, by (rows, slot)
        self._stream_twins: Dict[Tuple[int, int], Any] = {}
        #: a multi-lane stream's twins, by (lane key, rows, slot): each on its
        #: lane's device, so two lanes never share a twin or a graph
        self._lane_twins: Dict[Tuple[Any, int, int], Any] = {}
        #: the split vector (rows a lane) of each group of the last
        #: multi-lane stream launched through this process
        self.split_vectors: List[Tuple[int, ...]] = []

    # -- wiring ---------------------------------------------------------------
    @property
    def in_handle(self) -> DataHandle:
        """The primary (``"in"`` port) input handle."""
        return self.in_handles.get("in", INVALID_HANDLE)

    @in_handle.setter
    def in_handle(self, h: DataHandle) -> None:
        self.in_handles["in"] = h

    @property
    def input_names(self) -> Tuple[str, ...]:
        """The wired inputs in positional order: declared input ports first
        (``"in"`` always position 0), then any extra wired names."""
        wired = [n for n, h in self.in_handles.items() if h != INVALID_HANDLE]
        declared = [n for n in self.ports if n != "out"]
        ordered = [n for n in declared if n in wired]
        ordered += [n for n in wired if n not in ordered]
        if "in" in ordered and ordered[0] != "in":
            ordered.remove("in")
            ordered.insert(0, "in")
        return tuple(ordered) or ("in",)

    def getApp(self) -> CLapp:
        if self._app is None:
            raise RuntimeError("process not bound to a CLapp")
        return self._app

    def bind(self, infile: Any = None, outfile: Any = None, *, params: Any = None,
             **ports: Any):
        """Wire this process declaratively; returns a
        :class:`~repro_torch.core.graph.Node` for ``Pipeline(app) | node``.

        ``infile``/``outfile`` bind the ``"in"``/``"out"`` ports to an edge
        name, a Data or a registered handle; every other keyword binds the
        secondary input port of that name to an edge name (a join, which
        ``Pipeline.from_graph`` turns into a graph input when no node
        produces the edge) or to a Data or handle, read live at each
        launch (weights, a spliced row).  ``params`` forwards to
        :meth:`set_launch_parameters`."""
        from .graph import Node  # graph builds on Process

        if params is not None:
            self.set_launch_parameters(params)
        return Node(self, infile, outfile, ports)

    def out_specs(self, in_specs: Mapping[str, TensorSpec],
                  aux_specs: Optional[Mapping[str, Mapping[str, TensorSpec]]] = None,
                  ) -> Dict[str, TensorSpec]:
        """Infer the named output specs from input specs (and secondary
        inputs' specs by port name) without computing anything:
        :meth:`apply` runs on ``meta`` tensors."""
        def meta(s):
            return torch.empty(tuple(s.shape), dtype=torch_dtype(s.dtype),
                               device="meta")
        views = {k: meta(s) for k, s in in_specs.items()}
        aux = {n: {k: meta(s) for k, s in d.items()}
               for n, d in (aux_specs or {}).items()}
        outs = self.apply(views, aux, self.launch_params)
        return {k: TensorSpec(tuple(v.shape), spec_dtype(v.dtype))
                for k, v in outs.items()}

    # -- legacy imperative wiring (paper: setInHandle / setOutHandle) ---------
    def _warn_legacy_setters(self) -> None:
        if not self._legacy_warned:
            self._legacy_warned = True
            warnings.warn(
                f"{type(self).__name__}.set_in_handle/set_out_handle are "
                "deprecated: assign in_handle/in_handles/out_handle instead.",
                DeprecationWarning, stacklevel=3)

    def set_in_handle(self, h: DataHandle) -> None:
        self._warn_legacy_setters()
        self.in_handle = h

    def set_out_handle(self, h: DataHandle) -> None:
        self._warn_legacy_setters()
        self.out_handle = h

    def set_aux_handle(self, name: str, h: DataHandle) -> None:
        """Wire input ``name`` to ``h`` as a static input: a stream reads
        the same Data for every item (broadcast), where an input wired in
        ``in_handles`` takes one Data an item."""
        self.in_handles[name] = h
        self.aux_names.add(name)

    def set_launch_parameters(self, params: Any) -> None:
        if params != self.launch_params:
            self.launch_params = params
            self._initialized = False  # parameters shape the one-time work

    setInHandle = set_in_handle
    setOutHandle = set_out_handle
    setLaunchParameters = set_launch_parameters

    # -- the computation ------------------------------------------------------
    def apply(self, views: Dict[str, torch.Tensor],
              aux: Dict[str, Dict[str, torch.Tensor]], params: Any,
              out: Optional[Dict[str, torch.Tensor]] = None,
              ) -> Dict[str, torch.Tensor]:
        """Primary input views (+ secondary inputs' views, by port name, in
        ``aux``) -> named outputs.
        ``out``, when given, holds views of the output arena; an output
        computed straight into its view is not copied again."""
        raise NotImplementedError

    def _apply_checked(self, views, aux, out) -> Dict[str, torch.Tensor]:
        outs = self.apply(views, aux, self.launch_params, out)
        layout = self.getApp().getData(self.out_handle).layout
        missing = set(layout.names) - set(outs)
        if missing:
            raise ValueError(f"{type(self).__name__}.apply missing outputs {missing}")
        return outs

    # -- init / launch ----------------------------------------------------------
    def _validate_ports(self) -> None:
        app = self.getApp()
        owner = type(self).__name__
        wiring = dict(self.in_handles)
        wiring["out"] = self.out_handle
        for port_name, port in self.ports.items():
            h = wiring.get(port_name, INVALID_HANDLE)
            if h == INVALID_HANDLE:
                if port_name in ("in", "out") or not port.optional:
                    raise PortError(f"{owner}: port {port_name!r} is not wired")
                continue
            port.validate(app.getData(h).specs(), owner=owner, port=port_name,
                          lead=int(h in self._batched))

    def init(self) -> None:
        """One-time work: build and load kernels, plan layouts, check the
        ports, allocate the output arena."""
        self._release_stream()
        app = self.getApp()
        if self.kernel_names:
            app.loadKernels(list(self.kernel_names))
        self._validate_ports()
        self._in_names = self.input_names
        for h in [self.in_handles[n] for n in self._in_names] + [self.out_handle]:
            d = app.getData(h)
            if d.layout is None:
                d.plan()
        if app.getData(self.out_handle).device_blob is None:
            app.host2device(self.out_handle)
        self._in_place_name = next(
            (n for n in self._in_names if self.in_handles[n] == self.out_handle),
            None)
        self._drop_graph()
        self._initialized = True

    def _check_donation(self) -> None:
        name = self._in_place_name
        if name is not None and self.out_handle != self.in_handles.get(name):
            raise DonatedBufferError(
                f"{type(self).__name__} was initialised in place (input "
                f"{name!r} is the output) but is now wired out_handle="
                f"{self.out_handle} != in_handles[{name!r}]="
                f"{self.in_handles.get(name)}; call init() for the new wiring.")

    def _input_views(self, handle: DataHandle,
                     phases: Optional[_Phases] = None) -> Dict[str, torch.Tensor]:
        app = self.getApp()
        d = app.getData(handle)
        if d.device_blob is None:
            app.host2device(handle, phases)
        return d.device_views()

    def launch(self, profile: ProfileParameters | None = None) -> None:
        """Hot path: read the arena views, run, write the output arena.

        On a CPU app every launch runs eagerly.  On a CUDA app the launch
        is compiled: the first launch after ``init()`` runs eagerly, which
        warms up what a capture cannot do (cuBLAS handles, cuFFT plans,
        the kernel library's lazy load, the kernels' first
        ``cudaFuncSetAttribute``); the second captures the launch into one
        CUDA graph and replays it (capturing runs nothing); every later
        launch replays it.  The warm-up is not done in ``init()`` because
        it would run an in-place process on live state: a ``DecodeStep``
        would write K/V into every row of the server's cache.  A process
        launched once stays eager, and so does every launch of a class
        that sets :attr:`graphed` False.

        The graph belongs to the wiring it was captured on, as the JAX
        package's compiled executable does: ``init()``, a changed
        :meth:`set_launch_parameters`, a re-wired handle, or a blob of a
        read or written Data that moved or changed size since the capture
        drops it, and the next launch is eager again.  A capture or replay
        error reaches the caller; nothing falls back to an eager launch.

        ``profile`` records the launch's time as one sample and its phases,
        as the JAX package's launch does: ``"transfer"`` when the launch
        uploads an input or output Data that has no device blob (on the
        card the copy stream's events around the pinned copies), and
        ``"compute"`` around the launch (the sample's compute-stream
        events), or, for a staged :class:`ProcessChain`, around each stage.
        A launch records no ``"compile"``: as in the JAX package, whose
        ``init()`` compiles without a profile, a capture's cost stays in
        ``captures`` and ``capture_seconds``.

        The launch runs under the app's mesh (:func:`current_compile_mesh`):
        a process annotated with :func:`repro_torch.launch.mesh.
        shard_by_logical` splits its frames over the mesh's first model
        group.  A group that names more than one device runs eagerly: a
        CUDA graph holds one device's work.

        While a ``torch.profiler`` runs, the launch keeps the spans
        ``process.launch``, ``process.replay`` and ``process.capture``
        (:mod:`repro_torch.core.trace`)."""
        with trace.span("process.launch"):
            if not self._initialized:
                self.init()
            self._check_donation()
            app = self.getApp()
            on = profile is not None and profile.enable
            phases = _Phases(app.device) if on else None
            timer = _Timer(app.device) if on else None
            with _compiling_under(app.mesh):
                if self.graphed and _graphs_on(app.device) and _one_device(app.mesh):
                    self._launch_compiled(phases)
                else:
                    self._launch_eager(phases)
            if timer is not None:
                seconds = timer.seconds()
                profile.record(seconds)
                if not self._times_stages:
                    profile.record_phase("compute", seconds)
                phases.read(profile)

    @property
    def _times_stages(self) -> bool:
        """Whether a profiled launch times each stage (a staged chain), not
        the launch as a whole."""
        return False

    @property
    def _graph(self) -> Optional[_Graph]:
        """The unprofiled launch's graph, if captured."""
        return self._graphs.get(False)

    def _launch_compiled(self, phases: Optional[_Phases] = None) -> None:
        key = self._graph_key()
        if any(g.key != key for g in self._graphs.values()):
            self._drop_graph()
        timed = phases is not None and self._times_stages
        graph = self._graphs.get(timed)
        if graph is None:
            if not self._warm or key is None:
                self._launch_eager(phases)
                self._warm = True
                return
            graph = self._graphs[timed] = self._capture(key, timed)
        with trace.span("process.replay"):
            graph.replay()
        registry.add_launches(graph.launches, hit=1)
        self.replays += 1
        if timed:
            phases.spans.extend(graph.spans)
        self._mark_written()

    def _capture(self, key: Tuple, timed: bool = False) -> _Graph:
        """Capture one launch; ``timed`` records each stage's events into
        the graph (external events, recorded again by every replay)."""
        tally: Dict[str, int] = {}
        app = self.getApp()
        marks = _Phases(app.device, external=True) if timed else None

        def body() -> None:
            if marks is not None:
                marks.spans.clear()      # a body run again records anew
            with registry.counting_into(tally, app.device):
                self._run(marks)

        with trace.span("process.capture"):
            t0 = time.perf_counter()
            replay = capture_graph(body, app.device)
            self.capture_seconds += time.perf_counter() - t0
        self.captures += 1
        registry.count_capture()
        return _Graph(replay=replay, key=key, launches=dict(tally),
                      spans=marks.spans if marks is not None else [])

    def _drop_graph(self) -> None:
        self._graphs = {}
        self._warm = False

    def _graph_handles(self) -> List[DataHandle]:
        """Every handle whose blob a launch reads or writes."""
        return [self.in_handles[n] for n in self._in_names] + [self.out_handle]

    def _graph_key(self) -> Optional[Tuple]:
        """(handle, blob address, blob size) of every Data a launch reads or
        writes, or None while one has no device blob yet."""
        app = self.getApp()
        key = []
        for h in self._graph_handles():
            blob = app.getData(h).device_blob
            if blob is None:
                return None
            key.append((h, blob.data_ptr(), blob.numel()))
        return tuple(key)

    def _written_handles(self) -> List[DataHandle]:
        return [self.out_handle]

    def _mark_written(self) -> None:
        app = self.getApp()
        for h in self._written_handles():
            app._mark_written(h)

    def _launch_eager(self, phases: Optional[_Phases] = None) -> None:
        """One launch with no graph (a staged chain runs its stages so)."""
        self._run(phases)
        self._mark_written()

    def _run(self, phases: Optional[_Phases] = None) -> None:
        """A launch's device work: read the arena views, apply, write the
        output arena.  Captured as it is into the launch's graph.
        ``phases`` times the uploads of Data without a device blob."""
        app = self.getApp()
        ins = [self._input_views(self.in_handles[n], phases) for n in self._in_names]
        aux = dict(zip(self._in_names[1:], ins[1:]))
        dout = app.getData(self.out_handle)
        if dout.device_blob is None:
            app.host2device(self.out_handle, phases)
        if phases is not None:
            phases.end_transfers()
        outs = self._apply_checked(ins[0], aux, dout.device_views())
        pack_device(outs, dout.layout, out=dout.device_blob)

    # -- streaming (see repro_torch.core.stream) --------------------------------
    def stream(self, datasets: Sequence[Any], batch: int = 1, *, depth: int = 2,
               sync: bool = False, sharded: bool = False,
               tail_waste_threshold: float = 0.5, split: str = "equal",
               lanes: bool = False, profile: ProfileParameters | None = None) -> List[Any]:
        """Run many independent input Data sets through this process.

        Batches of ``batch`` items are packed into pinned host buffers,
        uploaded on the app's copy stream while the batch before computes
        (:class:`~repro_torch.core.stream.StreamQueue`, ``depth`` buffers),
        and each batch runs as ONE launch of a twin of this process wired
        for ``batch`` items (:class:`~repro_torch.core.stream.
        BatchedProcess`; on the card eager once, then captured and
        replayed as every launch is).  Returns one output Data per input,
        device-fresh (``sync=True`` also copies each back to its host
        arrays).

        For a multi-input process each item supplies one Data per streamed
        input (:meth:`stream_inputs`): a ``{input name -> Data}`` mapping or
        a positional tuple; an input bound with :meth:`set_aux_handle` is
        read unbatched by every item.

        Ragged tail: when the last batch has fewer than ``batch`` items and
        the padding waste fraction exceeds ``tail_waste_threshold``, it
        runs through a twin wired for its own row count instead of being
        padded by repetition (``>= 1.0`` always pads).

        ``sharded=True`` spreads each batch over the lanes of the app's
        mesh (:mod:`repro_torch.launch.mesh`; one lane a selected device,
        a model group on a 2D mesh): lane ``j`` runs its share of the rows
        through its own twins on its device, uploaded through its own
        pinned queue, and each item's result stays on the device that
        computed it.  The equal split needs ``batch`` divisible by the
        number of lanes; ``split="proportional"`` carves each batch by
        the lanes' measured throughput (``app.device_profiles``, balanced
        while cold) and ``lanes=True`` keeps the equal carve without the
        divisibility rule.  Both need ``sharded=True``.  A one-lane mesh
        of one device is the single-device stream.  Results equal
        ``launch()``'s as on one device."""
        from .stream import stream_launch  # stream builds on Process

        return stream_launch(self, datasets, batch=batch, depth=depth, sync=sync,
                             sharded=sharded, tail_waste_threshold=tail_waste_threshold,
                             split=split, lanes=lanes, profile=profile)

    def stream_inputs(self) -> Tuple[Tuple[str, DataHandle], ...]:
        """The inputs a stream feeds one Data an item, as (name, handle) in
        positional order: every wired input but those bound with
        :meth:`set_aux_handle`.  A handle wired to two ports appears once."""
        out: List[Tuple[str, DataHandle]] = []
        for n in self.input_names:
            h = self.in_handles.get(n, INVALID_HANDLE)
            if n in self.aux_names or h == INVALID_HANDLE or h in (x for _, x in out):
                continue
            out.append((n, h))
        return tuple(out)

    def _stream_target(self) -> "Process":
        """The process a stream launches (initialised): this one."""
        if not self._initialized:
            self.init()
        return self

    def _produced_handles(self) -> List[DataHandle]:
        """Every handle a launch writes."""
        return [self.out_handle]

    def _twin(self, handles: Mapping[DataHandle, DataHandle],
              app: Optional[CLapp] = None) -> "Process":
        """A copy of this process wired onto ``handles[h]`` in place of each
        handle ``h`` it reads or writes (a handle not in ``handles``, a
        static input, is kept), uninitialised and with no graph: the
        process a streamed batch launches, on batched Data.  ``app`` (a
        lane's app, which holds every handle of ``handles``) replaces the
        process's app."""
        if not self.batch_axis:
            raise NotImplementedError(
                f"{type(self).__name__} cannot take a leading batch axis, so it cannot be "
                "streamed or served (set batch_axis only where apply() handles the axis)")
        twin = copy.copy(self)
        if app is not None:
            twin._app = app
        twin.in_handles = {n: handles.get(h, h) for n, h in self.in_handles.items()}
        twin.out_handle = handles.get(self.out_handle, self.out_handle)
        twin.aux_names = set(self.aux_names)
        twin._batched = frozenset(handles.values())
        twin._initialized = False
        twin._graphs, twin._warm = {}, False
        twin.captures = twin.replays = 0
        twin.capture_seconds = 0.0
        twin._stream_twins = {}
        twin._lane_twins = {}
        return twin

    def _release_stream(self) -> None:
        """Free the twins of earlier streams (their Data leave their app):
        they were wired from this process as it was before ``init()``."""
        twins, self._stream_twins = self._stream_twins, {}
        lane_twins, self._lane_twins = self._lane_twins, {}
        for bp in list(twins.values()) + list(lane_twins.values()):
            bp.release()


class ProcessChain(Process):
    """Compose processes.  ``mode='staged'`` is the paper-faithful pipeline
    (each stage launched on its own, zero-copy handle passing);
    ``mode='fused'`` runs the stages' ``apply`` back to back so only the
    last stage writes an arena."""

    def __init__(self, app: Optional[CLapp] = None,
                 stages: Sequence[Process] = (), mode: str = "staged"):
        super().__init__(app)
        if mode not in ("staged", "fused"):
            raise ValueError(mode)
        self.stages = list(stages)
        self.mode = mode

    def add(self, p: Process) -> "ProcessChain":
        self.stages.append(p)
        return self

    def _chain_inputs(self) -> Tuple[List[DataHandle], List[str]]:
        """The chain-level inputs in first-consumption order: a handle a
        stage reads that no EARLIER stage produced, named after the port
        that first consumes it (``in<i>`` on a name collision)."""
        produced: set = set()
        inputs: List[DataHandle] = []
        names: List[str] = []
        for s in self.stages:
            for pname in s.input_names:
                h = s.in_handles.get(pname, INVALID_HANDLE)
                if h not in produced and h not in inputs:
                    if pname in names:
                        pname = f"in{len(inputs)}"
                    inputs.append(h)
                    names.append(pname)
            produced.add(s.out_handle)
        return inputs, names

    def init(self) -> None:
        if not self.stages:
            raise ValueError("empty chain")
        self._release_stream()
        for s in self.stages:
            s.init()
        inputs, names = self._chain_inputs()
        self.in_handles = dict(zip(names, inputs))
        self.out_handle = self.stages[-1].out_handle
        self._in_names = tuple(names)
        self._in_place_name = next(
            (n for n, h in zip(names, inputs) if h == self.out_handle), None)
        self._drop_graph()
        self._initialized = True

    @property
    def graphed(self) -> bool:
        """A chain is compiled when each of its stages would be."""
        return all(s.graphed for s in self.stages)

    @property
    def batch_axis(self) -> bool:
        """A chain takes a batch axis when each of its stages does."""
        return all(s.batch_axis for s in self.stages)

    def stream_inputs(self) -> Tuple[Tuple[str, DataHandle], ...]:
        """The chain-level inputs (first-consumption order and names) that
        some stage reads as a streamed input; one read only through static
        (:meth:`set_aux_handle`) ports is static for the chain too."""
        streamed = {s.in_handles[n] for s in self.stages for n in s.input_names
                    if n not in s.aux_names and n in s.in_handles}
        inputs, names = self._chain_inputs()
        return tuple((n, h) for n, h in zip(names, inputs) if h in streamed)

    def _stream_target(self) -> Process:
        # a stage given new launch parameters waits for the chain's init()
        if not self._initialized or not all(s._initialized for s in self.stages):
            self.init()
        return self

    def _produced_handles(self) -> List[DataHandle]:
        return [s.out_handle for s in self.stages]

    def _twin(self, handles: Mapping[DataHandle, DataHandle],
              app: Optional[CLapp] = None) -> Process:
        if not self.batch_axis:
            names = [type(s).__name__ for s in self.stages if not s.batch_axis]
            raise NotImplementedError(
                f"ProcessChain stages {names} cannot take a leading batch axis, so the "
                "chain cannot be streamed or served")
        twin = super()._twin(handles, app)
        twin.stages = [s._twin(handles, app) for s in self.stages]
        return twin

    def _graph_handles(self) -> List[DataHandle]:
        return [h for s in self.stages for h in s._graph_handles()]

    def _graph_key(self) -> Optional[Tuple]:
        # a stage given new launch parameters waits for its init()
        if not all(s._initialized for s in self.stages):
            return None
        return super()._graph_key()

    def _written_handles(self) -> List[DataHandle]:
        if self.mode == "staged":
            return [s.out_handle for s in self.stages]
        return [self.out_handle]

    @property
    def _times_stages(self) -> bool:
        return self.mode == "staged"

    def _run(self, phases: Optional[_Phases] = None) -> None:
        """Staged: each stage's own launch, with no graph of its own (the
        chain's graph holds them all), ``phases`` timing each stage under
        ``"compute"`` (a stage that is itself a staged chain times its own
        stages, as the JAX package's nested phase views do); fused: the
        stages' ``apply`` back to back, only the last one writing an
        arena."""
        if self.mode == "staged":
            # one event a stage boundary: a stage's end is the next's start
            start = phases.mark() if phases is not None else None
            for s in self.stages:
                if not s._initialized:
                    s.init()
                s._check_donation()
                s._launch_eager(phases)
                if phases is not None:
                    end = phases.mark()
                    if not s._times_stages:
                        phases.spans.append(("compute", start, end))
                    start = end
            return
        app = self.getApp()
        env: Dict[DataHandle, Dict[str, torch.Tensor]] = {
            h: self._input_views(h, phases) for h in self.in_handles.values()}
        if phases is not None:
            phases.end_transfers()
        last = len(self.stages) - 1
        for i, s in enumerate(self.stages):
            names = s.input_names
            views = env[s.in_handles[names[0]]]
            aux = {n: env[s.in_handles[n]] for n in names[1:]}
            out = app.getData(s.out_handle).device_views() if i == last else None
            env[s.out_handle] = s._apply_checked(views, aux, out)
        dout = app.getData(self.out_handle)
        pack_device(env[self.out_handle], dout.layout, out=dout.device_blob)
