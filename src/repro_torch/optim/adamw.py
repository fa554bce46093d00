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

On CUDA tensors the optimizer's two passes over the gradients are the
hand-written kernels of ``kernels/csrc/optim_kernels.cu``: the clip's sum
of squares (:func:`sum_squares`: a partial a block, then one block that
adds each leaf's partials in a fixed tree and the leaves in the tree's
order; no float atomics, so a replay gives the same bits) and one
``adamw_update_kernel`` launch a leaf (or ZeRO-1 piece) that reads the
gradient, master, m and v once and writes master, m, v and the cast
parameter, with the plain version's arithmetic op for op (bit for bit
given the same scalars).  They replace no TPU kernel: the JAX package's
optimizer is plain ``jnp``.  Both are bound by bytes (28 a bf16 parameter
for the update, 2 for the norm), so the design is one pass each with no
temporaries in device memory.  CPU tensors take the plain versions
(:func:`_update_leaf_plain`, :func:`_sum_squares_plain`); ``meta``
tensors and calls under a counting mode count the kernels' ``Cost``.
The step's scalar bookkeeping (:func:`adamw_scalars`) stays a handful of
0-d ops, and the norm's square root with it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.arena import tree_flatten
from repro_torch.core.registry import Cost, count_launch, kernel
from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda, counting, launch, nbytes, traced
from repro_torch.launch.mesh import Sharded
from repro_torch.models.common import tree_map
from .schedule import Schedule

#: elements the plain update takes at once: bounds the f32 temporaries of a
#: large leaf
CHUNK = 1 << 26
#: partial sums a piece in :func:`sum_squares`' pass on the card (one a
#: block; a smaller piece leaves the rest 0)
SUM_SLOTS = 512
DTYPES = (torch.float32, torch.bfloat16)


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


def _sum_squares_plain(pieces: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each piece's sum of squares in f32, added in order on the first
    piece's device."""
    sq = None
    for t in pieces:
        s = torch.sum(torch.square(t.float()))
        sq = s if sq is None else sq + (s if s.device == sq.device else s.to(sq.device))
    return sq


def _sum_squares_kernel(pieces: Sequence[torch.Tensor]) -> torch.Tensor:
    """One device's pieces: a partial pass a piece into its ``SUM_SLOTS``
    slots of a zeroed buffer, then the final pass into a 0-d f32 tensor."""
    dev = pieces[0].device
    pieces = [t.contiguous() for t in pieces]
    part = torch.zeros(len(pieces) * SUM_SLOTS, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    lib = _build.library()
    for i, t in enumerate(pieces):
        check_cuda(f"gradient piece {i}", t, DTYPES, device=dev, aligned=False)
        if t.numel():
            err = launch(lib.rt_sumsq_partial, t, t.data_ptr(), t.numel(),
                         int(t.dtype == torch.bfloat16), part.data_ptr() + 4 * i * SUM_SLOTS,
                         SUM_SLOTS)
            _build.check(err, "sum_squares")
            count_launch("sum_squares")
    _build.check(launch(lib.rt_sumsq_final, part, part.data_ptr(), len(pieces), SUM_SLOTS,
                        out.data_ptr()), "sum_squares")
    count_launch("sum_squares")
    return out


def sum_squares(pieces: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of every element's f32 square over ``pieces``, a 0-d f32
    tensor on the first piece's device.  On the card each run of pieces
    on one device is one call of :func:`_sum_squares_kernel`, and the runs'
    sums are added in order on the first device."""
    pieces = list(pieces)
    if pieces[0].is_meta or counting():
        dev = pieces[0].device
        return traced("sum_squares", lambda: sum_squares(pieces),
                      lambda: (torch.empty(len(pieces) * SUM_SLOTS, device=dev),
                               torch.empty((), dtype=torch.float32, device=dev))[1], pieces)
    if not pieces[0].is_cuda:
        return _sum_squares_plain(pieces)
    sq, start = None, 0
    for i in range(1, len(pieces) + 1):
        if i == len(pieces) or pieces[i].device != pieces[start].device:
            s = _sum_squares_kernel(pieces[start:i])
            sq = s if sq is None else sq + s.to(sq.device)
            start = i
    return sq


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares in f32, leaves summed in
    the tree's order (the reference's ``jax.tree.reduce``).  A leaf placed
    on a mesh (:class:`~repro_torch.launch.mesh.Sharded`) adds each
    distinct piece's sum once, in position order, on the first leaf's
    device: a piece that several lanes hold counts once."""
    return torch.sqrt(sum_squares(
        [t for _, g in tree_flatten(tree)
         for t in ([g.pieces[k] for k in g.unique()] if isinstance(g, Sharded) else [g])]))


def _update_leaf_plain(p, master, g, m, v, scalars: Dict[str, Any], cfg: AdamWConfig) -> None:
    """:func:`update_leaf`'s plain version: in slices of at most
    :data:`CHUNK` elements, a PyTorch op a step of the arithmetic."""
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


def _update_leaf_kernel(p, master, g, m, v, scalars: Dict[str, Any], cfg: AdamWConfig) -> None:
    """:func:`update_leaf` as one ``adamw_update_kernel`` launch."""
    dev = master.device
    check_cuda("master", master, (torch.float32,), aligned=False)
    for name, t in (("p", p), ("g", g)):
        check_cuda(name, t, DTYPES, device=dev, aligned=False)
    for name, t in (("m", m), ("v", v)):
        check_cuda(name, t, (torch.float32,), device=dev, aligned=False)
    n = master.numel()
    if any(t.numel() != n for t in (p, g, m, v)):
        raise ValueError(f"leaf sizes differ: p {p.numel()}, master {n}, g {g.numel()}, "
                         f"m {m.numel()}, v {v.numel()}")
    scale, lr, c1, c2 = (scalars[k] for k in ("scale", "lr", "c1", "c2"))
    clipped = isinstance(scale, torch.Tensor)    # else no clip: a Python 1.0
    for k, t in zip(("scale", "lr", "c1", "c2"), (scale, lr, c1, c2)):
        if (clipped or k != "scale") and not (isinstance(t, torch.Tensor) and t.numel() == 1
                                              and t.dtype == torch.float32 and t.device == dev):
            raise ValueError(f"AdamW scalar {k!r}: expected a 0-d f32 tensor on {dev}, got "
                             f"{t!r}")
    if not clipped and scale != 1.0:
        raise ValueError(f"AdamW scalar 'scale': expected a 0-d f32 tensor or 1.0 (no clip), "
                         f"got {scale!r}")
    if n == 0:
        return
    b1, b2 = cfg.b1, cfg.b2
    err = launch(_build.library().rt_adamw_update, master, p.data_ptr(), master.data_ptr(),
                 g.data_ptr(), m.data_ptr(), v.data_ptr(), n, int(p.dtype == torch.bfloat16),
                 int(g.dtype == torch.bfloat16), scale.data_ptr() if clipped else None,
                 lr.data_ptr(), c1.data_ptr(), c2.data_ptr(), b1, 1 - b1, b2, 1 - b2, cfg.eps,
                 cfg.weight_decay)
    _build.check(err, "adamw_update")
    count_launch("adamw_update")


def update_leaf(p, master, g, m, v, scalars: Dict[str, Any], cfg: AdamWConfig) -> None:
    """One leaf's update by the step's ``scalars`` (:func:`adamw_scalars`),
    in place (each element's arithmetic is the reference's): the kernel
    on CUDA tensors, the plain version on CPU ones."""
    if master.is_meta or counting():
        return traced("adamw_update", lambda: update_leaf(p, master, g, m, v, scalars, cfg),
                      lambda: None, p, master, g, m, v, scalars, cfg)
    if master.is_cuda:
        return _update_leaf_kernel(p, master, g.contiguous(), m, v, scalars, cfg)
    return _update_leaf_plain(p, master, g, m, v, scalars, cfg)


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


def adamw_update_cost(p, master, g, m, v, scalars=None, cfg=None) -> Cost:
    """Read the gradient, master, m and v, write master, m, v and the
    parameter (28 bytes an element for bf16 parameters and gradients, 32
    for f32); 17 flops an element (the update's multiplies, adds,
    divisions and square root)."""
    return Cost(17 * master.numel(), nbytes(g) + nbytes(p) + 6 * nbytes(master))


def sum_squares_cost(pieces) -> Cost:
    """Read each piece once (2 bytes an element in bf16, 4 in f32); a
    square and an add an element."""
    return Cost(2 * sum(t.numel() for t in pieces), sum(nbytes(t) for t in pieces))


kernel("adamw_update", ref=_update_leaf_plain, cost=adamw_update_cost)(update_leaf)
kernel("sum_squares", ref=_sum_squares_plain, cost=sum_squares_cost)(sum_squares)
