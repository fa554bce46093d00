"""Carry state across from the JAX package.

For this system the "weights" are data: the k-space arena and the
sensitivity maps.  The arena byte format is shared (``core/arena.py``), so
a host blob the JAX package packed is taken over as it is: same offsets,
same bytes.  Nothing is downloaded and nothing of the JAX package is
imported; what crosses is numpy bytes plus ``(name, shape, dtype)`` specs.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.arena import pack_host, plan_layout, unpack_host
from repro_torch.core.data import Data, KData, XData
from repro_torch.core.sync import Coherence


def _data_class(names) -> type:
    return KData if set(names) == {KData.KDATA, KData.SMAPS} else XData


def data_from_reference(blob: np.ndarray, specs: Sequence[Tuple[str, Sequence[int], Any]],
                        device: torch.device | str) -> Data:
    """A port ``KData`` (arrays ``kdata`` + ``sensitivity_maps``) or ``XData``
    from a host blob packed by the reference's ``pack_host`` for ``specs``.
    The blob lands on ``device`` (give ``app.device``) as the Data's arena;
    ``CLapp.addData`` keeps that arena and refuses one on another device."""
    blob = np.ascontiguousarray(blob, dtype=np.uint8).reshape(-1)
    layout = plan_layout(specs)
    if blob.size != layout.total_bytes:
        raise ValueError(f"blob has {blob.size} bytes, layout needs "
                         f"{layout.total_bytes}")
    host = blob.copy()
    arrays = unpack_host(host, layout)
    data = _data_class(arrays)(dict(arrays))
    data.layout = layout
    data.device_blob = torch.tensor(blob, device=device)  # a copy: no aliasing
    data.coherence = Coherence.IN_SYNC
    return data


def arrays_from_reference(arrays: Mapping[str, np.ndarray],
                          device: torch.device | str) -> Data:
    """The same from named arrays: packed in the shared format, then taken
    over as :func:`data_from_reference` does."""
    blob, layout = pack_host(arrays)
    return data_from_reference(
        blob, [(e.name, e.shape, e.dtype) for e in layout.entries], device)
