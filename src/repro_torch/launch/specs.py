"""TensorSpec stand-ins and placements for every (arch x shape) cell: the
counterpart of ``repro/launch/specs.py``.

``build_lowerable(arch, shape)`` returns what :mod:`.dryrun` needs: the
step the port runs, the specs of its arguments (nothing allocated) and
their placements on the production mesh.  Train cells use the step the
port runs over a mesh (:func:`repro_torch.train.step.make_mesh_train_step`,
with its ZeRO-1 optimizer pieces unless ``zero1=False``); prefill and
decode cells each model's ``prefill`` / ``decode_step``, whose weights the
port keeps whole on every lane (the decode's slot strips,
``DecodeStep``), with the cache placed by the model's
``cache_partition_rules``.  A spec is a tuple with one entry a dim (None,
an axis name, or a tuple of names), as everywhere in the port.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.configs import SHAPES, ShapeSpec, get_config, shape_applicable
from repro_torch.core.arena import spec_dtype, tree_flatten, tree_unflatten
from repro_torch.core.data import TensorSpec
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.models.common import (BATCH_AXES, MODEL, SLOT_AXES, ArchConfig,
                                       partition_tree, tree_map)
from repro_torch.optim import AdamWConfig
from repro_torch.train.step import (TrainConfig, batch_pspecs, make_mesh_train_step,
                                    state_pspecs, to_named, train_state_specs)

#: whisper: fixed encoder length (30 s of audio -> 1500 frames)
WHISPER_ENC_FRAMES = 1500


def spec_tree(tree) -> Any:
    """A tree of tensors (or anything with ``shape`` and ``dtype``) as
    :class:`~repro_torch.core.data.TensorSpec` leaves."""
    return tree_map(lambda a: TensorSpec(tuple(a.shape), spec_dtype(a.dtype)), tree)


def default_microbatches(cfg: ArchConfig, shape: ShapeSpec, mesh_data: int = 16,
                         budget_bytes: float = 2e9) -> int:
    """Grad-accum factor so the remat-saved activations (~L x tokens x d x 2B
    per data shard, x2 for MoE dispatch buffers / SSM conv+state streams)
    stay under ``budget_bytes``.  The numbers are the JAX package's, so
    that every cell is the same work in both packages: the 2e9 budget is
    the reference's definition of the cell (an eighth of a TPU v5e's HBM),
    not a property of the H100."""
    if shape.kind != "train":
        return 1
    rows = max(1, shape.batch // mesh_data)
    width = cfg.d_model * (2 if cfg.family in ("hybrid", "moe") else 1)
    est = cfg.n_layers * rows * shape.seq * width * 2
    mb = 1
    while est / mb > budget_bytes and mb < min(16, rows):
        mb *= 2
    return mb


@dataclasses.dataclass
class Lowerable:
    arch: str
    shape: str
    kind: str
    fn: Callable              # the step (train: a factory of the mesh step)
    specs: Tuple[Any, ...]    # TensorSpec trees, one per argument
    in_pspecs: Tuple[Any, ...]
    out_pspecs: Any           # or None
    donate: Tuple[int, ...] = ()
    note: str = ""
    model: Any = None
    cfg: Optional[ArchConfig] = None
    tcfg: Optional[TrainConfig] = None
    shape_spec: Optional[ShapeSpec] = None


def _spec(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(int(n) for n in shape), spec_dtype(dtype))


def _train_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, TensorSpec]:
    b, s = shape.batch, shape.seq
    if cfg.family == "encdec":
        # split the token budget: half encoder frames, half decoder tokens
        half = s // 2
        return {"frames": _spec((b, half, cfg.d_model), cfg.dtype),
                "tokens": _spec((b, half), "int32"),
                "labels": _spec((b, half), "int32")}
    if cfg.family == "vlm":
        # patch prefix + text fills the remaining positions
        text = s - cfg.n_patches
        return {"patch_embeds": _spec((b, cfg.n_patches, cfg.d_model), cfg.dtype),
                "tokens": _spec((b, text), "int32"),
                "labels": _spec((b, text), "int32")}
    return {"tokens": _spec((b, s), "int32"), "labels": _spec((b, s), "int32")}


def _cache_specs(model, cfg: ArchConfig, batch: int, max_len: int):
    if cfg.family == "encdec":
        return model.cache_specs(batch, max_len, WHISPER_ENC_FRAMES)
    return model.cache_specs(batch, max_len)


def _cache_pspecs(model, cache_specs, *, strips: bool = True):
    """The cache's specs by the model's ``cache_partition_rules``; without
    ``strips`` (a prefill, which a model group's first lane runs whole)
    the slot axis over the batch's axes only."""
    specs = partition_tree(cache_specs, model.cache_partition_rules())
    if strips:
        return specs

    def drop(spec):
        return tuple(tuple(a for a in e if a != MODEL) if isinstance(e, tuple) else e
                     for e in spec)
    return tree_unflatten((n, drop(s)) for n, s in tree_flatten(specs))


def _replicated(tree):
    return tree_map(lambda s: (), tree)


def resolve_shape(shape) -> ShapeSpec:
    """A shape's :class:`ShapeSpec`: by name from :data:`SHAPES`, or one
    given as it is."""
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def build_lowerable(arch: str, shape_name, *,
                    microbatches: Optional[int] = None,
                    compress_grads: bool = False,
                    zero1: bool = True,
                    cfg_override: Optional[ArchConfig] = None) -> Lowerable:
    """The cell's step, argument specs and placements.  ``shape_name`` is
    a name of :data:`SHAPES` or a :class:`ShapeSpec`."""
    cfg = cfg_override or get_config(arch)
    shape = resolve_shape(shape_name)
    ok, why = shape_applicable(cfg, shape.name)
    if not ok:
        raise ValueError(f"{arch} x {shape.name} skipped: {why}")
    model = build_model(cfg)
    common = dict(arch=arch, shape=shape.name, model=model, cfg=cfg, shape_spec=shape)

    if shape.kind == "train":
        mb = microbatches if microbatches is not None else default_microbatches(cfg, shape)
        tcfg = TrainConfig(microbatches=mb, compress_grads=compress_grads, opt=AdamWConfig())
        state_specs = train_state_specs(model, compress=compress_grads)
        batch_specs = _train_batch_specs(cfg, shape)
        sspec = state_pspecs(model, state_specs)
        if not zero1:
            sspec = {  # plain replicated-over-data optimizer
                "params": sspec["params"],
                "opt": {"master": sspec["params"], "m": sspec["params"],
                        "v": sspec["params"], "step": ()},
                **({"ef": sspec["params"]} if "ef" in sspec else {}),
            }
        bspec = batch_pspecs(batch_specs)
        return Lowerable(
            kind="train", fn=functools.partial(make_mesh_train_step, model, tcfg),
            specs=(state_specs, batch_specs), in_pspecs=(sspec, bspec),
            out_pspecs=(sspec, None), donate=(0,), tcfg=tcfg,
            note=f"microbatches={mb} zero1={zero1}", **common)

    params_specs = model.param_specs()
    pspec = _replicated(params_specs)           # whole weights on every lane
    rows = (BATCH_AXES,)
    cache_specs = _cache_specs(model, cfg, shape.batch, shape.seq)

    if shape.kind == "prefill":
        cspec = _cache_pspecs(model, cache_specs, strips=False)
        if cfg.family == "encdec":
            fn = lambda p, frames, toks, c: model.prefill(p, frames, toks, c)
            specs = (params_specs, _spec((shape.batch, WHISPER_ENC_FRAMES, cfg.d_model), cfg.dtype),
                     _spec((shape.batch, shape.seq), "int32"), cache_specs)
            in_pspecs = (pspec, rows + (None, None), rows + (None,), cspec)
        else:
            fn = lambda p, toks, c: model.prefill(p, toks, c)
            specs = (params_specs, _spec((shape.batch, shape.seq), "int32"), cache_specs)
            in_pspecs = (pspec, rows + (None,), cspec)
        return Lowerable(kind="prefill", fn=fn, specs=specs, in_pspecs=in_pspecs,
                         out_pspecs=(None, cspec), donate=(len(specs) - 1,),
                         note="weights whole on each lane; a model group's first lane "
                              "prefills its data lane's rows", **common)

    # decode: one new token against a seq_len-deep cache, slots in strips
    cspec = _cache_pspecs(model, cache_specs)
    fn = lambda p, tok, pos, c: model.decode_step(p, tok, pos, c)
    specs = (params_specs, _spec((shape.batch, 1), "int32"), _spec((), "int32"), cache_specs)
    in_pspecs = (pspec, (SLOT_AXES,), (), cspec)
    return Lowerable(kind="decode", fn=fn, specs=specs, in_pspecs=in_pspecs,
                     out_pspecs=(None, cspec), donate=(3,),
                     note="weights whole on each lane; slots in strips over model", **common)


def input_specs(arch: str, shape_name, **kw) -> Tuple[Any, ...]:
    """Paper-interface helper: the TensorSpec stand-ins for a cell."""
    return build_lowerable(arch, shape_name, **kw).specs


def named_shardings(pspec_tree, mesh: Mesh):
    """A spec tree as :class:`~repro_torch.launch.mesh.Placement` s over
    ``mesh`` (:func:`~repro_torch.train.step.to_named`)."""
    return to_named(pspec_tree, mesh)


def fit_pspec(spec, shape, mesh_shape: Dict[str, int]):
    """Argument placements must divide dims exactly.  Keep the largest
    prefix of each dim's axis tuple that divides; drop the rest (->
    replication on that dim).  E.g. vocab=49155 over 16 'model' shards ->
    replicated; batch=1 decode over ('pod','data') -> replicated.  Axes
    the mesh lacks are left out first, as the port's ``resolve_spec``
    does."""
    if spec is None:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        if e is None:
            out.append(None)
            continue
        axes = e if isinstance(e, (tuple, list)) else (e,)
        keep, cur = [], 1
        for a in axes:
            if a in mesh_shape and dim % (cur * mesh_shape[a]) == 0:
                keep.append(a)
                cur *= mesh_shape[a]
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(tuple(keep))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def fit_pspecs(pspec_tree, specs_tree, mesh: Mesh) -> Any:
    """Leaf-wise :func:`fit_pspec` of a spec tree against TensorSpecs (a
    lone spec against a lone TensorSpec too)."""
    mesh_shape = dict(mesh.shape)
    if isinstance(specs_tree, TensorSpec):
        return fit_pspec(pspec_tree, specs_tree.shape, mesh_shape)
    specs = dict(tree_flatten(specs_tree))
    return tree_unflatten((n, fit_pspec(s, specs[n].shape, mesh_shape))
                          for n, s in tree_flatten(pspec_tree))


def piece_shape(shape, spec, mesh_shape: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of one position's piece of a ``shape`` array placed by a
    fitted ``spec``."""
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        parts = 1
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            parts *= mesh_shape[a]
        out.append(int(n) // parts)
    return tuple(out)


def spec_nbytes(spec: TensorSpec, shape: Optional[Tuple[int, ...]] = None) -> int:
    """Bytes of an array of ``spec``'s dtype and ``shape`` (its own by
    default)."""
    itemsize = 2 if spec.dtype == "bfloat16" else np.dtype(spec.dtype).itemsize
    return int(np.prod(spec.shape if shape is None else shape, dtype=np.int64)) * itemsize


def placed_bytes(specs_tree, pspec_tree, mesh: Mesh) -> int:
    """Bytes one position holds of a tree placed by fitted specs."""
    mesh_shape = dict(mesh.shape)
    if isinstance(specs_tree, TensorSpec):
        return spec_nbytes(specs_tree, piece_shape(specs_tree.shape, pspec_tree, mesh_shape))
    specs = dict(tree_flatten(specs_tree))
    return sum(spec_nbytes(specs[n], piece_shape(specs[n].shape, s, mesh_shape))
               for n, s in tree_flatten(pspec_tree))


__all__ = ["Lowerable", "WHISPER_ENC_FRAMES", "build_lowerable", "default_microbatches",
           "fit_pspec", "fit_pspecs", "input_specs", "named_shardings", "piece_shape",
           "placed_bytes", "resolve_shape", "spec_tree"]
