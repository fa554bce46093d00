"""AdamW with f32 master weights and global-norm clipping, mirroring
``repro/optim/adamw.py``.  The step's scalars (:func:`adamw_scalars`) and
each leaf's update (:func:`update_leaf`) are apart, so the mesh train step
updates each grid position's ZeRO-1 piece of a leaf with the whole
gradient's scalars (:func:`global_norm` reads a gradient in its pieces).

State per parameter leaf: ``master``, ``m`` and ``v`` in f32; the step
counter is a 0-d int32 tensor on the device.  The gradient arrives in the
parameter's dtype (bf16 for bf16 parameters) and is cast to f32 here, the
reference's order.  ``adamw_update`` writes the new master, moments,
parameters and step into the state's and the parameters' own tensors (one
leaf, and one slice of a large leaf, at a time: each element's arithmetic
is the reference's, and no second copy of the f32 state is ever held), so
a step captured into a CUDA graph replays onto the same buffers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.arena import tree_flatten
from repro_torch.launch.mesh import Sharded
from repro_torch.models.common import tree_map
from .schedule import Schedule

#: elements updated at once: bounds the f32 temporaries of a large leaf
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: Schedule = dataclasses.field(default_factory=Schedule)


def adamw_init(params) -> Dict[str, Any]:
    """f32 master (always a distinct buffer, even for f32 parameters), zero
    moments and a zero step counter on the parameters' device."""
    leaves = tree_flatten(params)
    device = leaves[0][1].device if leaves else "cpu"
    return {"master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares in f32, leaves summed in
    the tree's order (the reference's ``jax.tree.reduce``).  A leaf placed
    on a mesh (:class:`~repro_torch.launch.mesh.Sharded`) adds each
    distinct piece's sum once, in position order, on the first leaf's
    device: a piece that several lanes hold counts once."""
    sq = None
    for _, g in tree_flatten(tree):
        for t in ([g.pieces[k] for k in g.unique()] if isinstance(g, Sharded) else [g]):
            s = torch.sum(torch.square(t.float()))
            sq = s if sq is None else sq + (s if s.device == sq.device else s.to(sq.device))
    return torch.sqrt(sq)


def update_leaf(p, master, g, m, v, scalars: Dict[str, Any], cfg: AdamWConfig) -> None:
    """One leaf's update by the step's ``scalars`` (:func:`adamw_scalars`),
    in place, in slices of at most :data:`CHUNK` elements (the arithmetic
    of each element is the reference's)."""
    b1, b2 = cfg.b1, cfg.b2
    scale, lr, c1, c2 = (scalars[k] for k in ("scale", "lr", "c1", "c2"))
    n = master.numel()
    flat = [t.view(-1) for t in (p, master)] + [g.reshape(-1)] + [t.view(-1) for t in (m, v)]
    for i in range(0, n, CHUNK):
        pp, pm, gg, mm, vv = (t[i:i + CHUNK] for t in flat)
        g32 = gg.float() * scale
        m_new = b1 * mm + (1 - b1) * g32
        v_new = b2 * vv + (1 - b2) * g32 * g32
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        master_new = pm - lr * (delta + cfg.weight_decay * pm)
        mm.copy_(m_new)
        vv.copy_(v_new)
        pm.copy_(master_new)
        pp.copy_(master_new)                     # cast to the parameter's dtype


def adamw_scalars(step: torch.Tensor, grads, cfg: AdamWConfig) -> Dict[str, Any]:
    """The step's scalars: the new step count, ``lr``, the global norm of
    ``grads`` (before clipping), the clip ``scale`` and the bias
    corrections ``c1``, ``c2``."""
    step = step + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        scale = 1.0
    stepf = step.to(torch.float32)
    return {"step": step, "lr": cfg.schedule(step), "grad_norm": gnorm, "scale": scale,
            "c1": 1.0 - torch.pow(cfg.b1, stepf), "c2": 1.0 - torch.pow(cfg.b2, stepf)}


def adamw_update(params, grads, state, cfg: AdamWConfig) -> Tuple[Any, Dict[str, Any], Dict]:
    """One AdamW step; returns (params, state, metrics ``lr`` and
    ``grad_norm``, the norm before clipping).  ``params`` and ``state``
    are updated in place and returned."""
    with torch.no_grad():
        sc = adamw_scalars(state["step"], grads, cfg)
        trees = [dict(tree_flatten(t)) for t in
                 (params, state["master"], grads, state["m"], state["v"])]
        for name in trees[0]:
            update_leaf(*(t[name] for t in trees), sc, cfg)
        state["step"].copy_(sc["step"])
    return params, state, {"lr": sc["lr"], "grad_norm": sc["grad_norm"]}
