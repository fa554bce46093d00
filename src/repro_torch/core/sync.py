"""Host/device coherence tracking (OpenCLIPER's ``SyncSource``).

A :class:`~repro_torch.core.data.Data` object may hold a host (numpy) copy,
a device (torch uint8 blob) copy, or both, and the two can go stale
relative to one another after a Process writes the device side.
"""
from __future__ import annotations

import enum


class SyncSource(enum.Enum):
    """Which side of a Data object is authoritative."""

    AUTO = 0         # framework picks whichever copy is marked fresh
    BUFFER_ONLY = 1  # device buffer is authoritative (paper's BUFFER_ONLY)
    HOST_ONLY = 2    # host memory is authoritative


class Coherence(enum.Enum):
    """Freshness state of the (host, device) pair backing a Data object.

    The states are the reference's.  ``DEVICE_RESIDENT`` marks a Data the
    Pipeline keeps on the device (a persistent decode state) after a
    process wrote it.  ``TRANSFERRING`` (an upload issued, not awaited) is
    never set by the port: its uploads, ``host2device``'s and the
    streaming executor's, are ordered before the kernels that read them on
    the device, so a Data is IN_SYNC as soon as ``host2device`` returns,
    and a streamed result is DEVICE_FRESH.
    """

    HOST_FRESH = "host"        # host copy newer (or device absent)
    DEVICE_FRESH = "device"    # device copy newer (or host absent)
    IN_SYNC = "sync"           # both copies identical
    EMPTY = "empty"            # no storage attached yet
    TRANSFERRING = "h2d"       # host->device transfer issued, not awaited
    DEVICE_RESIDENT = "resident"


def resolve_source(sync: SyncSource, coherence: Coherence) -> str:
    """Return ``"host"`` or ``"device"``: where to read authoritative data."""
    if sync is SyncSource.BUFFER_ONLY:
        return "device"
    if sync is SyncSource.HOST_ONLY:
        return "host"
    if coherence in (Coherence.DEVICE_FRESH, Coherence.DEVICE_RESIDENT,
                     Coherence.IN_SYNC, Coherence.TRANSFERRING):
        return "device"
    if coherence is Coherence.HOST_FRESH:
        return "host"
    raise ValueError("Data object has no storage to synchronise from")
