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

from repro_torch.core.arena import (host_array, is_bfloat16, pack_host, plan_layout,
                                    tree_unflatten, unpack_host)
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


def _tensor(value: Any, dtype: Any, device) -> torch.Tensor:
    """A host array as a tensor of ``dtype`` on ``device`` (bfloat16 taken
    bit for bit)."""
    a = np.array(host_array(value, dtype), order="C")   # a copy; 0-d stays 0-d
    if is_bfloat16(dtype):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def train_state_from_reference(named_arrays: Mapping[str, np.ndarray], cfg: ArchConfig,
                               device: torch.device | str) -> dict:
    """The port's train state (:func:`repro_torch.train.make_train_state`'s
    layout) for ``cfg`` from the JAX package's, flattened to ``{keystr
    path: numpy array}``: ``params`` in their dtypes (bfloat16 bit for
    bit), ``opt`` ``master`` / ``m`` / ``v`` in f32 and ``step`` int32,
    and ``ef`` when the reference state has one, on ``device``.  Both
    packages then take the same steps from the same state."""
    specs = tree_flatten(build_model(cfg).param_specs())
    groups = ["['params']"] + [f"['opt']['{k}']" for k in ("master", "m", "v")]
    if any(n.startswith("['ef']") for n in named_arrays):
        groups.append("['ef']")
    want = {g + p for g in groups for p, _ in specs} | {"['opt']['step']"}
    missing, extra = sorted(want - set(named_arrays)), sorted(set(named_arrays) - want)
    if missing or extra:
        raise ValueError(f"train state does not match {cfg.name}: missing {missing}, "
                         f"unexpected {extra}")

    def leaf(name: str, dtype: Any, shape) -> torch.Tensor:
        if tuple(np.shape(named_arrays[name])) != tuple(shape):
            raise ValueError(f"{name}: shape {np.shape(named_arrays[name])}, {cfg.name} has "
                             f"{tuple(shape)}")
        return _tensor(named_arrays[name], dtype, device)

    flat = [(g + p, leaf(g + p, spec.dtype if g == "['params']" else np.float32, spec.shape))
            for g in groups for p, spec in specs]
    flat.append(("['opt']['step']", leaf("['opt']['step']", np.int32, ())))
    return tree_unflatten(flat)
