"""CLapp — the application/device-management object (paper §III-B).

Owns device selection by traits, the data registry (handle -> Data with a
device-resident arena blob) and the kernel registry.  ``init()`` selects
the device in one call; ``addData`` registers a Data set and moves it to
the device in one pinned copy; ``loadKernels`` builds the kernels.

Device selection never falls back: the default ``DeviceType.ANY`` means
the CUDA card, and without one ``init()`` raises
:class:`NoMatchingDeviceError`.  The CPU runs only when the caller asks for
it with ``DeviceTraits(type=DeviceType.CPU)``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence

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
        self._data: Dict[DataHandle, Data] = {}
        self._next_handle: DataHandle = 0
        self.kernels = KernelRegistry()
        self._initialized = False
        self._copy_stream = None     # side stream for pinned uploads
        #: host->device bytes copied per handle by ``host2device`` (zeroing a
        #: spec-only Data's blob on the device moves none)
        self.h2d_bytes: Dict[DataHandle, int] = {}

    # ------------------------------------------------------------------ init
    def init(self, platform_traits: PlatformTraits | None = None,
             device_traits: DeviceTraits | None = None) -> "CLapp":
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
        return self

    @property
    def devices(self) -> List[torch.device]:
        if not self._initialized:
            raise RuntimeError("CLapp.init() has not been called")
        return self._devices

    @property
    def device(self) -> torch.device:
        return self.devices[0]

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

    def host2device(self, handle: DataHandle, phases=None) -> None:
        """Pack + transfer a Data set in one call (the paper's single-call
        pinned transfer).  On CUDA the packed blob is staged in pinned
        memory and copied with ``non_blocking=True`` on a side stream; the
        compute stream waits on the copy's event, so later kernels see the
        data without the host blocking.  An existing device blob of the
        right size is reused.  ``phases`` (a profiled launch's) takes the
        copy's timing events: on CUDA a pair on the copy stream around the
        pinned copy, on the CPU the host clock around pack and copy."""
        data = self.getData(handle)
        if data.layout is None:
            data.plan()
        n = data.layout.total_bytes
        blob = data.device_blob
        if blob is None or blob.numel() != n or blob.device != self.device:
            blob = torch.empty(n, dtype=torch.uint8, device=self.device)
        # a profiled launch's upload events: on CUDA on the copy stream
        # around the pinned copy, else around pack and copy
        span = None if phases is None else []
        cuda = self.device.type == "cuda"
        if span is not None and not cuda:
            span.append(phases.mark())
        if all(a.host is not None for a in data):
            host = torch.from_numpy(data.pack_host())
            coherence = Coherence.IN_SYNC
            if cuda:
                staging = host.pin_memory()  # the caching host allocator
                # keeps it alive until the copy that reads it has run
                compute = torch.cuda.current_stream(self.device)
                copy_stream = self.copy_stream
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
        """The side stream of host->device copies on a CUDA app (made at
        first use): ``host2device``'s and the streaming executor's."""
        if self.device.type != "cuda":
            raise RuntimeError(f"a {self.device.type} app has no copy stream")
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._copy_stream

    def wait_transfers(self) -> None:
        """Explicit host sync point: block until every issued host->device
        copy has landed.  Kernels need no such wait: the compute stream is
        already ordered after each copy."""
        if self._copy_stream is not None:
            self._copy_stream.synchronize()

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
