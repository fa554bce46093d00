"""CLapp — the application/device-management object (paper §III-B).

Owns device selection by traits, the data registry (handle -> Data with a
device-resident arena blob) and the kernel registry.  ``init()`` selects
the device in one call; ``addData`` registers a Data set and moves it to
the device in one pinned copy; ``loadKernels`` builds the kernels.

Device selection never falls back: the default ``DeviceType.ANY`` means
the CUDA cards, and without one ``init()`` raises
:class:`NoMatchingDeviceError`.  The CPU runs only when the caller asks for
it with ``DeviceTraits(type=DeviceType.CPU)``.

``init()`` also builds the ``("data", "model")`` mesh over the selected
devices (:mod:`repro_torch.launch.mesh`), one lane a device, and the app
keeps the per-lane throughput profiles (:attr:`CLapp.device_profiles`)
that the streaming executor's ``split="proportional"`` policy reads.
Everything downstream (sharded, proportional and per-lane streams and
serves) is device-count-agnostic: selecting N devices is all the caller
does.  :meth:`CLapp.set_mesh` replaces the mesh, for example with one that
names a device more than once (eight lanes on the one CPU, two on one
card).  :meth:`CLapp.split` partitions the mesh's devices into replica
apps.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence

import torch

from .data import Data
from .registry import KernelRegistry
from .sync import Coherence, SyncSource

DataHandle = int
INVALID_HANDLE: DataHandle = -1


class DeviceType(enum.Enum):
    ANY = "any"
    CPU = "cpu"
    GPU = "gpu"


@dataclasses.dataclass
class PlatformTraits:
    """Selection criteria for the *platform*: ``"cuda"`` or ``"cpu"``
    (``None`` = decided by the device traits)."""

    name: Optional[str] = None


@dataclasses.dataclass
class DeviceTraits:
    """Selection criteria for the computing device."""

    type: DeviceType = DeviceType.ANY
    index: Optional[int] = None          # pick the i-th matching device
    min_count: int = 1                   # need at least this many devices
    count: Optional[int] = None          # use exactly this many (None = all)


class NoMatchingDeviceError(RuntimeError):
    pass


class CLapp:
    """Main framework object.  ``init`` selects the device in a single call
    (paper §III-A.1a); ``addData`` registers + transfers a Data set in a
    single call (§III-A.2a); ``loadKernels`` builds kernels (§III-A.3a)."""

    def __init__(self):
        self._devices: List[torch.device] = []
        self._mesh = None
        self._mesh_explicit = False  # set_mesh() called; init() must not rebuild
        self._data: Dict[DataHandle, Data] = {}
        self._next_handle: DataHandle = 0
        self.kernels = KernelRegistry()
        self._initialized = False
        #: side streams for pinned uploads, one a CUDA device (made at first
        #: use; shared with the app's lane apps)
        self._copy_streams: Dict[torch.device, Any] = {}
        #: measured per-lane throughput (items/sec), fed by proportionally
        #: split streams and read back to carve the next batch
        from repro_torch.launch.mesh import DeviceProfileRegistry  # lazy: keep core light
        self.device_profiles = DeviceProfileRegistry()
        #: the streaming executor's lanes, by (position, group) (repro_torch.core.stream)
        self._stream_lanes: Dict[Any, Any] = {}
        #: proportional launches whose timing events the registry has not read yet
        self._pending_rates: List[Any] = []
        #: host->device bytes copied per handle by ``host2device`` (zeroing a
        #: spec-only Data's blob on the device moves none)
        self.h2d_bytes: Dict[DataHandle, int] = {}

    # ------------------------------------------------------------------ init
    def init(self, platform_traits: PlatformTraits | None = None,
             device_traits: DeviceTraits | None = None, model_axis: int = 1) -> "CLapp":
        """Select devices and build the app mesh.  ``model_axis=m`` folds
        the selected devices into a ``(n//m, m)`` mesh, so each lane is a
        model group over which annotated processes split their frames
        (:func:`repro_torch.launch.mesh.shard_by_logical`); the device
        count must be a multiple of ``m``.  A mesh given with
        :meth:`set_mesh` is kept."""
        platform_traits = platform_traits or PlatformTraits()
        device_traits = device_traits or DeviceTraits()
        kind = platform_traits.name or (
            None if device_traits.type is DeviceType.ANY
            else device_traits.type.value)
        if kind in (None, "gpu", "cuda"):
            if not torch.cuda.is_available():
                raise NoMatchingDeviceError(
                    "no CUDA device found; the CPU is used only when asked "
                    "for with DeviceTraits(type=DeviceType.CPU)")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        elif kind == "cpu":
            devices = [torch.device("cpu")]
        else:
            raise NoMatchingDeviceError(f"no devices for platform {kind!r}")
        if device_traits.index is not None:
            if device_traits.index >= len(devices):
                raise NoMatchingDeviceError(
                    f"device index {device_traits.index} out of range "
                    f"({len(devices)} found)")
            devices = [devices[device_traits.index]]
        if len(devices) < device_traits.min_count:
            raise NoMatchingDeviceError(
                f"need >= {device_traits.min_count} devices, found {len(devices)}")
        if device_traits.count is not None:
            devices = devices[: device_traits.count]
        self._devices = devices
        self._initialized = True
        if not self._mesh_explicit:
            # rebuilt on every init(): a re-selection never leaves a stale
            # mesh over deselected devices
            from repro_torch.launch.mesh import make_data_mesh
            self._mesh = make_data_mesh(devices, model=model_axis)
        return self

    @property
    def devices(self) -> List[torch.device]:
        if not self._initialized:
            raise RuntimeError("CLapp.init() has not been called")
        return self._devices

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def split(self, n: int) -> List["CLapp"]:
        """Partition the mesh's devices (the selected devices, or those of
        a mesh given with :meth:`set_mesh`, in grid order) into ``n``
        independent replica apps: each owns a contiguous, disjoint share
        with its own one-lane-a-device mesh, data registry, kernel registry
        and :class:`~repro_torch.launch.mesh.DeviceProfileRegistry`.  Each
        replica needs at least one device; extra devices go to the earlier
        replicas."""
        devices = self.devices            # raises if init() never ran
        if self._mesh is not None:
            devices = self._mesh.device_list
        if n < 1:
            raise ValueError(f"need n >= 1 replicas, got {n}")
        if n > len(devices):
            raise ValueError(f"cannot split {len(devices)} device(s) into {n} replicas "
                             "(each replica needs at least one device)")
        from repro_torch.launch.mesh import DeviceProfileRegistry, make_data_mesh
        base, extra = divmod(len(devices), n)
        apps, start = [], 0
        for i in range(n):
            stop = start + base + (1 if i < extra else 0)
            app = CLapp()
            app._devices = list(devices[start:stop])
            app._mesh = make_data_mesh(app._devices)
            app._initialized = True
            app.device_profiles = DeviceProfileRegistry(ema=self.device_profiles.ema)
            apps.append(app)
            start = stop
        return apps

    # ------------------------------------------------------------------ mesh
    def set_mesh(self, mesh) -> None:
        """Use ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`) instead
        of the one ``init()`` builds; ``set_mesh(None)`` goes back to it at
        the next ``init()``.  A mesh naming a CUDA device that is not
        present raises :class:`NoMatchingDeviceError`: nothing runs on
        another device in its place."""
        if mesh is not None:
            from repro_torch.launch.mesh import check_present
            check_present(mesh)
        self._mesh = mesh
        self._mesh_explicit = mesh is not None

    @property
    def mesh(self):
        """The app's ``(data, model)`` :class:`~repro_torch.launch.mesh.Mesh`."""
        return self._mesh

    def data_sharding(self, layout: Optional[Sequence[Optional[str]]] = None):
        """A :class:`~repro_torch.launch.mesh.Placement` over the app mesh:
        ``layout`` names a mesh axis (or None) per array dim; the default
        replicates."""
        if self._mesh is None:
            raise RuntimeError("CLapp has no mesh (init() not called?)")
        from repro_torch.launch.mesh import Placement
        return Placement(self._mesh, tuple(layout or ()))

    @property
    def default_sharding(self):
        """Placement of single (unbatched) Data blobs: the primary device."""
        from repro_torch.launch.mesh import pinned_sharding
        return pinned_sharding(self.device)

    def _lane_app(self, group: Sequence[torch.device]) -> "CLapp":
        """An app for one lane of the streaming executor: its device is the
        group's first, its mesh the group's ``(1, m)`` mesh; it has its own
        data registry and shares this app's kernels and copy streams."""
        from repro_torch.launch.mesh import make_group_mesh
        lane = CLapp()
        lane._devices = [group[0]]
        lane._mesh = make_group_mesh(group)
        lane._mesh_explicit = True
        lane._initialized = True
        lane.kernels = self.kernels
        lane._copy_streams = self._copy_streams
        return lane

    # ----------------------------------------------------------------- kernels
    def loadKernels(self, modules: str | Sequence[str]) -> List[str]:
        return self.kernels.load(modules, device=self.device)

    # ------------------------------------------------------------------- data
    def addData(self, data: Data, to_device: bool = True) -> DataHandle:
        """Register a Data set; pack it into one arena blob and transfer it
        in a single call.  Spec-only Data gets a zeroed device blob.  A Data
        that already carries a device blob (``interop``) is registered as
        it is; a blob on another device than the app's raises, so no
        process of this app ever runs on data that lies elsewhere."""
        blob = data.device_blob
        if blob is not None and blob.device != self.device:
            raise ValueError(
                f"Data's arena lies on {blob.device}, this app runs on "
                f"{self.device}; make it on app.device")
        handle = self._next_handle
        self._next_handle += 1
        self._data[handle] = data
        if to_device and data.device_blob is None:
            self.host2device(handle)
        return handle

    def getData(self, handle: DataHandle) -> Data:
        try:
            return self._data[handle]
        except KeyError:
            raise KeyError(f"invalid data handle {handle}") from None

    def delData(self, handle: DataHandle) -> None:
        data = self._data.pop(handle, None)
        if data is not None:
            data.device_blob = None

    def host2device(self, handle: DataHandle, phases=None, *, sharding=None) -> None:
        """Pack + transfer a Data set in one call (the paper's single-call
        pinned transfer).  On CUDA the packed blob is staged in pinned
        memory and copied with ``non_blocking=True`` on a side stream; the
        compute stream waits on the copy's event, so later kernels see the
        data without the host blocking.  An existing device blob of the
        right size is reused.  ``phases`` (a profiled launch's) takes the
        copy's timing events: on CUDA a pair on the copy stream around the
        pinned copy, on the CPU the host clock around pack and copy.
        ``sharding`` (a :class:`~repro_torch.launch.mesh.Placement`, e.g.
        :func:`~repro_torch.launch.mesh.pinned_sharding`) puts the blob on
        its device instead of :attr:`device`."""
        data = self.getData(handle)
        if data.layout is None:
            data.plan()
        target = self.device if sharding is None else sharding.device
        n = data.layout.total_bytes
        blob = data.device_blob
        if blob is None or blob.numel() != n or blob.device != target:
            blob = torch.empty(n, dtype=torch.uint8, device=target)
        # a profiled launch's upload events: on CUDA on the copy stream
        # around the pinned copy, else around pack and copy
        span = None if phases is None else []
        cuda = target.type == "cuda"
        if span is not None and not cuda:
            span.append(phases.mark())
        if all(a.host is not None for a in data):
            host = torch.from_numpy(data.pack_host())
            coherence = Coherence.IN_SYNC
            if cuda:
                staging = host.pin_memory()  # the caching host allocator
                # keeps it alive until the copy that reads it has run
                compute = torch.cuda.current_stream(target)
                copy_stream = self.copy_stream_for(target)
                # the blob may still be read by kernels queued earlier
                copy_stream.wait_stream(compute)
                event = torch.cuda.Event()
                with torch.cuda.stream(copy_stream):
                    if span is not None:
                        span.append(phases.mark(copy_stream))
                    blob.copy_(staging, non_blocking=True)
                    if span is not None:
                        span.append(phases.mark(copy_stream))
                    event.record(copy_stream)
                blob.record_stream(copy_stream)
                compute.wait_event(event)
            else:
                blob.copy_(host)
            self.h2d_bytes[handle] = self.h2d_bytes.get(handle, 0) + n
        else:
            if span is not None and cuda:
                span.append(phases.mark())
            blob.zero_()
            coherence = Coherence.DEVICE_FRESH
        if span is not None:
            if len(span) == 1:
                span.append(phases.mark())
            phases.uploaded(*span)
        data.device_blob = blob
        data.coherence = coherence

    @property
    def copy_stream(self) -> "torch.cuda.Stream":
        """The side stream of host->device copies to :attr:`device` on a
        CUDA app (made at first use): ``host2device``'s and the streaming
        executor's."""
        return self.copy_stream_for(self.device)

    def copy_stream_for(self, device: torch.device) -> "torch.cuda.Stream":
        """The copy stream of one CUDA device (made at first use): every
        upload to that device, whichever lane it serves, runs on it."""
        device = torch.device(device)
        if device.type != "cuda":
            raise RuntimeError(f"a {device.type} device has no copy stream")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        stream = self._copy_streams.get(device)
        if stream is None:
            stream = self._copy_streams[device] = torch.cuda.Stream(device)
        return stream

    def wait_transfers(self) -> None:
        """Explicit host sync point: block until every issued host->device
        copy has landed.  Kernels need no such wait: the compute stream is
        already ordered after each copy."""
        for stream in self._copy_streams.values():
            stream.synchronize()

    def device2Host(self, handle: DataHandle,
                    sync: SyncSource = SyncSource.BUFFER_ONLY) -> None:
        if sync is SyncSource.HOST_ONLY:
            return  # host already authoritative
        self.getData(handle).sync_to_host()

    def _mark_written(self, handle: DataHandle) -> None:
        """A process wrote this Data's device blob: the device copy is now
        the newer one, and the only one for a device-resident Data."""
        data = self.getData(handle)
        data.coherence = (Coherence.DEVICE_RESIDENT if data.residency == "device"
                          else Coherence.DEVICE_FRESH)
