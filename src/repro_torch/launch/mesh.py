"""Device meshes and per-lane throughput profiles (the counterpart of
``repro/launch/mesh.py``).

Two concerns live here, both device-count housekeeping the framework hides
from user code (paper §III-A.1a: selecting devices is the ONLY
device-dependent call the user makes):

* **Mesh construction**: a ``("data", "model")`` grid of ``torch.device`` s
  (:class:`Mesh`).  :class:`repro_torch.core.app.CLapp` builds
  :func:`make_data_mesh` over its selected devices at ``init()``, one
  device a lane.  Each row of the grid is a **lane**: one model group
  that runs a share of every streamed batch (:mod:`repro_torch.core.
  stream`).  The grid may name one device more than once: a mesh of
  ``[torch.device("cpu")] * 8`` gives eight lanes on the one CPU (how the
  CPU tests get eight lanes, as the JAX tests force eight host devices),
  and ``[cuda:0, cuda:0]`` two lanes on one card.

* **Throughput profiles**: :class:`DeviceProfile` /
  :class:`DeviceProfileRegistry`, the measured items/sec of each lane
  behind the streaming executor's ``split="proportional"`` policy.
  Profiles are keyed by the lane's **position in the mesh** (its data-axis
  row), where the JAX registry keys by ``device.id``: the two agree while
  devices are distinct, and positions stay distinct when a device repeats.

PyTorch has no ``shard_map``: :func:`shard_by_logical` splits the dims
annotated with a logical axis bound to ``model`` over the devices of one
model group, runs the function on each piece on its device, and joins the
pieces in order.  Items and frames are independent, so no collective runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

class Mesh:
    """A ``(data, model)`` (or ``(pod, data, model)``) grid of
    ``torch.device`` s with axis names.

    ``devices`` is the grid as an object array, one axis a name; ``shape``
    maps each axis name to its size, as a JAX mesh's does.  Each row over
    the last (``model``) axis (:attr:`groups`) is a lane: the model group
    that runs one share of a streamed batch or one data-parallel slice of
    a training batch.  Two meshes are equal when their axis names and
    device grids are."""

    def __init__(self, devices: Sequence[Any],
                 axis_names: Tuple[str, ...] = ("data", "model")):
        axis_names = tuple(axis_names)
        if len(axis_names) not in (2, 3):
            raise ValueError(f"a mesh has two axes (data, model) or three (pod, data, model), "
                             f"got {axis_names!r}")
        self.axis_names = axis_names
        self.devices = _grid(devices, len(axis_names))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def groups(self) -> Tuple[Tuple[torch.device, ...], ...]:
        """The rows of the grid over its last axis: one model group (lane)
        each, in row-major order."""
        rows = self.devices.reshape(-1, self.devices.shape[-1])
        return tuple(tuple(row) for row in rows)

    @property
    def device_list(self) -> List[torch.device]:
        """Every device of the grid in row-major order (repeats kept)."""
        return list(self.devices.flat)

    @property
    def device_set(self) -> set:
        return set(self.devices.flat)

    def key(self) -> Tuple:
        """Axis names, grid shape and every device in grid order."""
        return (self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _grid(devices: Sequence[Any], ndim: int) -> np.ndarray:
    """Nested rows of devices as an object array of ``ndim`` axes."""
    grid = np.array(devices, dtype=object)
    if grid.size == 0:
        raise ValueError("cannot build a mesh over zero devices")
    if grid.ndim != ndim:
        raise ValueError("mesh rows must all hold the same number of devices")
    for idx in np.ndindex(grid.shape):
        grid[idx] = torch.device(grid[idx])
    return grid


def check_present(mesh: Mesh) -> None:
    """Raise :class:`~repro_torch.core.app.NoMatchingDeviceError` when the
    mesh names a CUDA device that is not present (or a platform that is
    neither the CPU nor CUDA): nothing runs on another device in its place."""
    from repro_torch.core.app import NoMatchingDeviceError   # lazy: no cycle
    for d in mesh.device_set:
        if d.type == "cuda" and (not torch.cuda.is_available() or (
                d.index or 0) >= torch.cuda.device_count()):
            raise NoMatchingDeviceError(
                f"the mesh names {d}, which is not present "
                f"({torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                "CUDA device(s) found)")
        if d.type not in ("cuda", "cpu"):
            raise NoMatchingDeviceError(f"no devices for platform {d.type!r}")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's training mesh over the visible cards: ``(data
    16, model 16)``, or ``(pod 2, data 16, model 16)`` with
    ``multi_pod``.  Fewer cards than the mesh holds raise, naming both
    counts, as ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise RuntimeError(f"the production mesh {dict(zip(axes, shape))} needs {need} CUDA "
                           f"devices; {have} found")
    devices = np.array([torch.device("cuda", i) for i in range(need)], dtype=object)
    return Mesh(devices.reshape(shape), axes)


def make_data_mesh(devices: Sequence[Any], axis_names: Tuple[str, str] = ("data", "model"),
                   model: int = 1) -> Mesh:
    """A ``(data, model)`` mesh over the given devices.

    ``model=1`` (the default) puts every device on the ``data`` axis: one
    lane a device, the mesh :class:`repro_torch.core.app.CLapp` builds over
    its selected devices.  ``model=m`` folds the devices into a
    ``(len(devices)//m, m)`` grid, row-major: consecutive devices form one
    model group, whose members each run a share of the frames of the rows
    given to the group (:data:`LOGICAL_AXES`, :func:`shard_by_logical`)."""
    devices = list(devices)
    if not devices:
        raise ValueError("cannot build a mesh over zero devices")
    if model < 1:
        raise ValueError(f"model-axis size must be >= 1, got {model}")
    if len(devices) % model:
        raise ValueError(
            f"{len(devices)} device(s) do not fold into a (data, model={model}) "
            "mesh; the model-axis size must divide the device count")
    return Mesh([devices[j:j + model] for j in range(0, len(devices), model)], axis_names)


def make_host_mesh() -> Mesh:
    """The host's CPU as a one-lane ``(data, model)`` mesh."""
    return make_data_mesh([torch.device("cpu")])


def make_device_mesh(device: Any, axis_names: Tuple[str, str] = ("data", "model")) -> Mesh:
    """A one-device ``(1, 1)`` mesh: where a lane's twins and uploads live
    (:mod:`repro_torch.core.stream`)."""
    return Mesh([[device]], axis_names)


def make_group_mesh(devices: Sequence[Any],
                    axis_names: Tuple[str, str] = ("data", "model")) -> Mesh:
    """A ``(1, m)`` mesh over one model group: the mesh a lane's twins are
    set up under on a 2D app mesh.  A one-device group is exactly
    :func:`make_device_mesh`."""
    devices = list(devices)
    if not devices:
        raise ValueError("cannot build a group mesh over zero devices")
    return Mesh([devices], axis_names)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a blob lands: a mesh and one mesh-axis name (or None) per
    array dim (``spec``), the port's ``NamedSharding``.  ``spec=()``
    replicates.  A Data holds one device blob, which ``host2device`` puts
    on :attr:`device` (the mesh's first device); a lane's replicas of
    static inputs are made by the streaming executor."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    @property
    def device(self) -> torch.device:
        return self.mesh.devices.flat[0]

    @property
    def device_set(self) -> set:
        return self.mesh.device_set


def resolve_spec(spec: Sequence[Any], mesh: Mesh) -> Tuple[Any, ...]:
    """``spec`` with the axes ``mesh`` lacks dropped (an entry left with
    none replicates; trailing replicated entries go): the JAX package's
    ``resolve_spec``, so one spec serves a (data, model) and a (pod, data,
    model) mesh."""
    out: List[Any] = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            keep = tuple(a for a in e if a in mesh.axis_names)
            # one axis left: its name, as a JAX PartitionSpec normalizes it
            out.append(keep if len(keep) > 1 else (keep[0] if keep else None))
        else:
            out.append(e if e in mesh.axis_names else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def piece_index(shape: Sequence[int], spec: Sequence[Any], mesh: Mesh,
                position: int) -> List[List[int]]:
    """``[[start, stop], ...]`` a dim: the piece of a ``shape`` array that
    grid position ``position`` (row-major) holds under ``spec``.  A dim
    split over several axes is cut row-major over them, as a JAX
    ``NamedSharding`` cuts it; a dim the axes do not divide raises."""
    coords = dict(zip(mesh.axis_names, np.unravel_index(position, mesh.devices.shape)))
    spec = resolve_spec(spec, mesh)
    out = []
    for d, size in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        parts, k = 1, 0
        for a in axes:
            parts, k = parts * mesh.shape[a], k * mesh.shape[a] + int(coords[a])
        if size % parts:
            raise ValueError(f"dim {d} of size {size} does not split into {parts} pieces "
                             f"over {axes}")
        n = size // parts
        out.append([k * n, (k + 1) * n])
    return out


def _slices(index: Sequence[Sequence[int]]) -> Tuple[slice, ...]:
    return tuple(slice(a, b) for a, b in index)


class Sharded:
    """A leaf placed on a mesh: its :class:`Placement`, logical shape, and
    one piece a grid position (row-major), each a tensor on that
    position's device holding :meth:`index` of the logical array.  A
    replicated dim gives every position the whole dim, so each position
    owns a copy (two lanes on one card hold two).  The port's counterpart
    of a JAX array under a ``NamedSharding``."""

    def __init__(self, placement: Placement, shape: Sequence[int],
                 pieces: Sequence[torch.Tensor]):
        if len(pieces) != placement.mesh.devices.size:
            raise ValueError(f"{len(pieces)} pieces for a mesh of "
                             f"{placement.mesh.devices.size} positions")
        self.placement = placement
        self.shape = tuple(int(n) for n in shape)
        self.pieces = list(pieces)

    @property
    def mesh(self) -> Mesh:
        return self.placement.mesh

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    def index(self, position: int) -> List[List[int]]:
        return piece_index(self.shape, self.placement.spec, self.mesh, position)

    def slices(self, position: int) -> Tuple[slice, ...]:
        return _slices(self.index(position))

    @property
    def replicated(self) -> bool:
        """Whether every position holds the whole array."""
        return all(a == 0 and b == n for k in range(len(self.pieces))
                   for (a, b), n in zip(self.index(k), self.shape))

    def unique(self) -> List[int]:
        """The positions that hold a piece no earlier position holds
        (replicated pieces: first position wins)."""
        seen, out = set(), []
        for k in range(len(self.pieces)):
            key = tuple(map(tuple, self.index(k)))
            if key not in seen:
                seen.add(key)
                out.append(k)
        return out

    def full(self, device: Any = "cpu") -> torch.Tensor:
        """The logical array, assembled on ``device`` from the pieces."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for k in self.unique():
            out[self.slices(k)].copy_(self.pieces[k])
        return out

    @classmethod
    def place(cls, x: torch.Tensor, placement: Placement) -> "Sharded":
        """Cut ``x`` into the pieces ``placement`` gives each position and
        copy each to its device."""
        mesh = placement.mesh
        pieces = [x[_slices(piece_index(x.shape, placement.spec, mesh, k))]
                  .to(mesh.devices.flat[k], copy=True).contiguous()
                  for k in range(mesh.devices.size)]
        return cls(placement, x.shape, pieces)

    @classmethod
    def zeros(cls, shape: Sequence[int], dtype: torch.dtype, placement: Placement) -> "Sharded":
        """Zeros of ``shape`` placed by ``placement``, each piece made on
        its device (no logical array anywhere)."""
        mesh = placement.mesh
        pieces = [torch.zeros([b - a for a, b in piece_index(shape, placement.spec, mesh, k)],
                              dtype=dtype, device=mesh.devices.flat[k])
                  for k in range(mesh.devices.size)]
        return cls(placement, shape, pieces)

    def __repr__(self) -> str:
        return (f"Sharded({self.shape}, {self.dtype}, spec={self.placement.spec}, "
                f"mesh={self.mesh.shape})")


def pinned_sharding(device: Any) -> Placement:
    """Replicated over :func:`make_device_mesh`: where a lane's upload or a
    static input's replica lands."""
    return Placement(make_device_mesh(device))


def group_sharding(devices: Sequence[Any]) -> Placement:
    """Replicated over :func:`make_group_mesh`: where a model group's
    sub-batch lands on a 2D mesh (its first device; the group's launch
    splits the frames over the group)."""
    return Placement(make_group_mesh(devices))


# ---------------------------------------------------------------------------
# Logical axes: name every weight/activation axis ONCE, bind names to mesh
# axes in one table
# ---------------------------------------------------------------------------

#: THE logical-axis table: the single place a logical array-axis name is
#: bound to a mesh axis (or to ``None`` = never partitioned).  Processes
#: annotate their arrays with these names (:func:`shard_by_logical`).
LOGICAL_AXES: Dict[str, Optional[str]] = {
    # streamed items / decode batch rows ride the data axis (the streaming
    # executor's batch placement; see repro_torch.core.stream)
    "batch": "data",
    # large per-item grids split over the model axis: independent MRI
    # frames, and decode slots (each slot's row + cache strip is
    # self-contained up to the shared scalar position, a max over slots)
    "frame": "model",
    "slot": "model",
    # per-item working axes: never partitioned
    "coil": None, "height": None, "width": None,
    "layer": None, "head": None, "seq": None, "embed": None, "vocab": None,
}


def mesh_axis(logical: Optional[str]) -> Optional[str]:
    """Mesh axis a logical axis name is bound to (``None`` = replicated).
    Unknown names are an error: the table is the contract."""
    if logical is None:
        return None
    if logical not in LOGICAL_AXES:
        raise KeyError(
            f"unknown logical axis {logical!r}; add it to "
            f"repro_torch.launch.mesh.LOGICAL_AXES (known: {sorted(LOGICAL_AXES)})")
    return LOGICAL_AXES[logical]


def logical_pspec(axes: Optional[Sequence[Optional[str]]]) -> Tuple[Optional[str], ...]:
    """The mesh axis of each dim of an array whose dims carry the given
    logical names (``None`` entries, and ``axes=None`` entirely,
    replicate): the port's ``PartitionSpec``, a tuple."""
    if axes is None:
        return ()
    return tuple(mesh_axis(a) for a in axes)


def logical_sharding(mesh: Mesh, axes: Optional[Sequence[Optional[str]]]) -> Placement:
    """A :class:`Placement` over ``mesh`` from logical axis names."""
    return Placement(mesh, logical_pspec(axes))


def model_axis_size(mesh: Optional[Mesh]) -> int:
    """Size of the mesh's ``model`` axis (1 when there is no mesh)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get("model", 1))


def _on(device: torch.device):
    """Make ``device`` the current CUDA device for the block (nothing on
    the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_by_logical(fn: Callable, in_axes: Sequence[Optional[Sequence[Optional[str]]]],
                     out_axes, *, mesh: Optional[Mesh] = None) -> Callable:
    """Partition ``fn`` over a model group, with per-dim *logical* axis
    names instead of mesh axes.

    ``in_axes`` holds one annotation per positional argument: a tuple of
    logical names (one per dim, ``None`` = a dim that is not split) or
    ``None`` for an argument every piece reads whole.  ``out_axes``
    annotates a single output the same way; a **list** of annotations
    annotates a tuple-returning ``fn`` per output.

    The wrapper is a **total no-op** (it calls ``fn`` directly) whenever
    partitioning cannot apply: no mesh (``mesh=None`` and no launch in
    progress), a trivial ``model`` axis, or any split dim not divisible by
    the axis size.  ``mesh=None`` resolves the mesh of the launch in
    progress (:func:`repro_torch.core.process.current_compile_mesh`):
    one annotated ``apply`` body runs whole in a lane's twin on a 1D mesh
    and split over the model group in a group's twin.

    Where it applies, each dim bound to ``model`` is cut into as many equal
    pieces as the first model group of the mesh has devices; piece ``i``
    runs on the group's device ``i`` (arguments moved there when they lie
    elsewhere, under that device), and the outputs are concatenated in
    order on the first argument's device.  ``out=`` (one output) goes to
    ``fn`` as its ``out=`` when the call stays whole, and else receives the
    concatenation.  A dim bound to ``data`` is left whole: the
    streaming executor carves the data axis itself."""
    in_axes = tuple(in_axes)

    def wrapped(*args, out: Optional[torch.Tensor] = None):
        from repro_torch.core.process import current_compile_mesh  # lazy: no cycle
        m = mesh if mesh is not None else current_compile_mesh()
        if m is None:
            return _whole(fn, args, out)
        if len(args) != len(in_axes):
            raise ValueError(f"shard_by_logical: {len(args)} argument(s) but "
                             f"{len(in_axes)} in_axes annotation(s)")
        parts = model_axis_size(m)
        in_specs = [logical_pspec(a) for a in in_axes]
        listed = isinstance(out_axes, list)
        out_specs = [logical_pspec(a) for a in (out_axes if listed else [out_axes])]
        if parts == 1 or not any("model" in s for s in in_specs + out_specs):
            return _whole(fn, args, out)              # nothing to partition
        for arg, spec in zip(args, in_specs):
            for d, ax in enumerate(spec):
                if ax == "model" and arg.shape[d] % parts:
                    return _whole(fn, args, out)      # indivisible: stay whole
        group = m.groups[0]
        home = next(a.device for a in args if isinstance(a, torch.Tensor))
        pieces = []
        for i, dev in enumerate(group):
            piece_args = []
            for arg, spec in zip(args, in_specs):
                if "model" in spec:
                    d = spec.index("model")
                    n = arg.shape[d] // parts
                    arg = arg.narrow(d, i * n, n).contiguous()
                if isinstance(arg, torch.Tensor) and arg.device != dev:
                    arg = arg.to(dev)
                piece_args.append(arg)
            with _on(dev):
                res = fn(*piece_args)
            pieces.append(res if listed else (res,))
        joined = []
        for o, spec in enumerate(out_specs):
            outs = [p[o] if p[o].device == home else p[o].to(home) for p in pieces]
            if "model" not in spec:
                joined.append(outs[0])
                continue
            dst = out if (not listed and out is not None) else None
            joined.append(torch.cat(outs, dim=spec.index("model"), out=dst))
        return tuple(joined) if listed else joined[0]

    return wrapped


def _whole(fn: Callable, args: Tuple, out: Optional[torch.Tensor]):
    return fn(*args) if out is None else fn(*args, out=out)


# ---------------------------------------------------------------------------
# Per-lane throughput profiles (EngineCL-style measured load balancing)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceProfile:
    """Measured throughput of one lane: items/sec, refined per launch.

    ``record(items, seconds)`` folds one observation into an exponential
    moving average (``ema`` weight on the newest sample), so the estimate
    tracks drifting device speed without a warm-up restart.  The raw
    per-launch times are kept in a :class:`~repro_torch.core.process.
    ProfileParameters` (``seconds``)."""

    lane: int
    ema: float = 0.3
    items: int = 0                  # total items this lane has processed
    _rate: float = float("nan")     # EMA items/sec

    def __post_init__(self):
        # lazy import: mesh stays importable before core is set up
        from repro_torch.core.process import ProfileParameters
        self.seconds = ProfileParameters(enable=True)

    def record(self, items: int, seconds: float) -> None:
        """Fold one measured launch (``items`` rows in ``seconds``) in."""
        if items <= 0 or seconds <= 0:
            return
        self.seconds.record(seconds)
        self.items += int(items)
        sample = items / seconds
        if self.cold:
            self._rate = sample
        else:
            self._rate = self.ema * sample + (1.0 - self.ema) * self._rate

    @property
    def rate(self) -> float:
        """Current items/sec estimate; ``nan`` when nothing was recorded."""
        return self._rate

    @property
    def cold(self) -> bool:
        return self._rate != self._rate      # nan check

    def set_rate(self, rate: float) -> None:
        """Seed the estimate directly (benchmarks, tests, emulated pools)."""
        if rate < 0:
            raise ValueError(f"rate must be >= 0 items/sec, got {rate}")
        self._rate = float(rate)


class DeviceProfileRegistry:
    """Per-lane :class:`DeviceProfile` store owned by a ``CLapp``, keyed
    by the lane's position in the mesh (an int).

    The streaming executor records into it from every proportionally-split
    launch (one sample per lane per batch, read from the launch's timing
    events once they completed) and reads it back through :meth:`split` to
    carve the next stacked batch.  Thread-safe."""

    def __init__(self, ema: float = 0.3):
        self.ema = ema
        self._profiles: Dict[int, DeviceProfile] = {}
        self._lock = threading.Lock()

    def profile(self, lane: int) -> DeviceProfile:
        lane = int(lane)
        with self._lock:
            p = self._profiles.get(lane)
            if p is None:
                p = DeviceProfile(lane=lane, ema=self.ema)
                self._profiles[lane] = p
            return p

    def record(self, lane: int, items: int, seconds: float) -> None:
        p = self.profile(lane)
        with self._lock:
            p.record(items, seconds)

    def set_rate(self, lane: int, rate: float) -> None:
        p = self.profile(lane)
        with self._lock:
            p.set_rate(rate)

    def rates(self, lanes: Sequence[int]) -> List[float]:
        """Current items/sec estimate per lane (``nan`` where cold)."""
        return [self.profile(j).rate for j in lanes]

    def warm(self, lanes: Sequence[int]) -> bool:
        """True when EVERY given lane has a measured rate."""
        return all(not self.profile(j).cold for j in lanes)

    def total_rate(self, lanes: Sequence[int]) -> float:
        """Aggregate measured capacity of ``lanes`` in items/sec, or ``nan``
        until every one is warm."""
        rates = self.rates(lanes)
        if any(r != r for r in rates):
            return float("nan")
        return float(sum(rates))

    def reset(self) -> None:
        with self._lock:
            self._profiles.clear()

    def split(self, rows: int, lanes: Sequence[int]) -> Optional[Tuple[int, ...]]:
        """Per-lane row counts for ``rows`` items, proportional to the
        measured rates, or ``None`` when the proportional carve is not
        justified and the caller should fall back to an equal split:

        * any lane's profile is **cold** (no measurement yet),
        * the batch is **too small to matter** (``rows < 2 * len(lanes)``),
        * every measured rate is zero (degenerate).

        A zero-rate lane gets **zero rows**.  Rounding is largest-remainder
        with ties broken by lane order, so the vector is deterministic for
        given rates and always sums to ``rows``."""
        n = len(lanes)
        if n == 0:
            raise ValueError("cannot split over zero devices")
        if rows < 2 * n:
            return None
        rates = self.rates(lanes)
        if any(r != r for r in rates):       # any cold -> fall back
            return None
        total = sum(rates)
        if total <= 0:
            return None
        quotas = [rows * r / total for r in rates]
        counts = [int(q) for q in quotas]
        remainder = rows - sum(counts)
        order = sorted(range(n), key=lambda i: (-(quotas[i] - counts[i]), i))
        for i in order[:remainder]:
            counts[i] += 1
        return tuple(counts)

    @staticmethod
    def balanced(rows: int, n: int) -> Tuple[int, ...]:
        """The equal-split fallback vector: rows spread as evenly as they
        divide (the first ``rows % n`` lanes carry one extra row)."""
        if n <= 0:
            raise ValueError("cannot split over zero devices")
        base, extra = divmod(rows, n)
        return tuple(base + (1 if i < extra else 0) for i in range(n))
