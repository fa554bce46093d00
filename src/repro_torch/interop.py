"""Carry state across from the JAX package.

For the MRI path the "weights" are data: the k-space arena and the
sensitivity maps.  For the LM path they are a model's parameters.  The
arena byte format is shared (``core/arena.py``), so a host blob the JAX
package packed is taken over as it is: same offsets, same bytes.  Nothing
is downloaded and nothing of the JAX package is imported; what crosses is
numpy arrays plus ``(name, shape, dtype)`` specs.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.arena import pack_host, plan_layout, unpack_host
from repro_torch.core.data import Data, KData, NDArray, XData
from repro_torch.core.sync import Coherence
from repro_torch.models import build_model
from repro_torch.models.common import ArchConfig, tree_flatten


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


def params_from_reference(named_arrays: Mapping[str, np.ndarray], cfg: ArchConfig,
                          device: torch.device | str) -> Data:
    """The port's weights Data for ``cfg`` from the JAX package's parameters
    flattened to ``{keystr path: numpy array}`` (``jax.tree_util.keystr``
    of each leaf path, e.g. ``"['layers']['attn']['w_q']"``).  Entries are
    named, ordered and typed as :func:`repro_torch.processes.lm.weights_data`
    lays them out (bfloat16 arrays are taken bit for bit); the packed arena
    lands on ``device``.  Hand it to ``LMServer`` / ``DecodeSession``.

    An encoder-decoder's learned decoder positions (``['pos_dec']``) have
    as many rows as the array given."""
    model = build_model(cfg)
    if cfg.family == "encdec" and "['pos_dec']" in named_arrays:
        specs = tree_flatten(model.param_specs(np.shape(named_arrays["['pos_dec']"])[0]))
    else:
        specs = tree_flatten(model.param_specs())
    missing = sorted({p for p, _ in specs} - set(named_arrays))
    extra = sorted(set(named_arrays) - {p for p, _ in specs})
    if missing or extra:
        raise ValueError(f"parameters do not match {cfg.name}: missing {missing}, "
                         f"unexpected {extra}")
    data = Data({f"w{path}": NDArray(named_arrays[path], dtype=spec.dtype)
                 for path, spec in specs})
    for a, (path, spec) in zip(data, specs):
        if a.shape != tuple(spec.shape):
            raise ValueError(f"{path}: shape {a.shape}, {cfg.name} has {tuple(spec.shape)}")
    data.plan()
    data.device_blob = torch.from_numpy(data.pack_host()).to(device)
    data.coherence = Coherence.IN_SYNC
    return data
