"""repro_torch.core — the paper's framework skeleton on PyTorch.

Public API mirrors OpenCLIPER's class names (CLapp, Data, XData, KData,
NDArray, Process) and ``repro.core``'s exports, limited to what the port
has so far: the graph layer (``Node``, ``Pipeline`` in its launch, stream
and serve modes) and the streaming executor (``StreamQueue``,
``BatchedProcess``), on one device or over the lanes of the app's mesh
(``repro_torch.launch.mesh``).
"""
from .app import (
    CLapp,
    DataHandle,
    DeviceTraits,
    DeviceType,
    INVALID_HANDLE,
    NoMatchingDeviceError,
    PlatformTraits,
)
from .arena import (
    ALIGN,
    BFLOAT16,
    ArenaEntry,
    ArenaLayout,
    device_view,
    pack_device,
    pack_host,
    plan_layout,
    unpack_device,
    unpack_host,
)
from .data import Data, KData, NDArray, TensorSpec, XData
from .graph import GraphError, Node, Pipeline
from .process import (
    DonatedBufferError,
    Port,
    PortError,
    Process,
    ProcessChain,
    ProfileParameters,
    compile_cache_stats,
)
from .registry import KernelCompileError, KernelEntry, KernelRegistry, kernel
from .stream import BatchedProcess, StreamQueue
from .sync import Coherence, SyncSource

__all__ = [
    "ALIGN", "ArenaEntry", "ArenaLayout", "BFLOAT16", "BatchedProcess", "CLapp", "Coherence",
    "Data", "DataHandle", "DeviceTraits", "DeviceType", "DonatedBufferError",
    "GraphError", "INVALID_HANDLE", "KData", "KernelCompileError", "KernelEntry",
    "KernelRegistry", "NDArray", "Node", "NoMatchingDeviceError", "Pipeline",
    "PlatformTraits", "Port", "PortError", "Process", "ProcessChain", "ProfileParameters",
    "StreamQueue", "SyncSource", "TensorSpec", "XData", "compile_cache_stats", "device_view",
    "kernel",
    "pack_device", "pack_host", "plan_layout", "unpack_device", "unpack_host",
]
