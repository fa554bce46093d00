"""Mixture-of-Experts layer: top-k router and capacity-bounded scatter
dispatch (granite-moe, deepseek-v2-lite).

Mirrors ``repro/models/moe.py``.  Routing positions, the capacity and the
scatter are local to each batch row: a token's (token, k) choices take
slots in its row's (expert, slot) buffer in (token, k) order, and a choice
past an expert's capacity C goes to the dump slot E·C and is dropped.  The
dispatch has a fixed shape whatever the data (``topk``, ``cumsum``,
``where``, ``scatter_``/``gather`` into a (B, E·C + 1, D) buffer; no
``nonzero``, boolean-mask indexing or host read), so the decode step that
runs it is captured into a CUDA graph.  As in the reference, every expert
multiplies its C slots, filled or not, and the expert products are plain
``torch.einsum`` (the reference's ``jnp.einsum``, outside any Pallas
kernel).

Over a model group (``group=``) the experts lie over ``model``: every lane
computes the same router output and dispatch, runs only its E/M experts'
slots (a buffer of its own experts; the other lanes' choices go to its
dump slot), and the lanes' combined outputs, with their columns of the
shared experts, are reduced once.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import layers as L
from . import parallel as tp
from .common import ArchConfig
from .layers import _spec as spec
from .parallel import ModelGroup

Params = Dict[str, object]


def moe_specs(cfg: ArchConfig, d_ff: Optional[int] = None) -> Params:
    """The router (f32, (D, E)), the SwiGLU expert stacks (E, D, F) and
    (E, F, D), and the shared experts as one MLP of width F · n_shared."""
    d, f, e, pd = cfg.d_model, d_ff or cfg.d_ff, cfg.n_experts, cfg.param_dtype
    p = {"router": spec((d, e), "float32"), "w_gate": spec((e, d, f), pd),
         "w_up": spec((e, d, f), pd), "w_down": spec((e, f, d), pd)}
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_specs(cfg, d_ff=f * cfg.n_shared_experts)
    return p


def row_capacity(s: int, cfg: ArchConfig) -> int:
    """Slots per (row, expert): capacity_factor · S · top_k / E, rounded
    up to a multiple of 8, at least 8."""
    c = int(cfg.capacity_factor * s * cfg.top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _route(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """The router and the dispatch of x (B, S, D): router probs (B, S, E)
    f32, gate values and expert ids (B, S, K), the slot of each (token, k)
    choice within its (row, expert) (B, S·K), and whether it is kept."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ p["router"], dim=-1)         # (B, S, E) f32
    gate_vals, eids = torch.topk(probs, k, dim=-1)                  # (B, S, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # slot of each (token, k) choice within its (row, expert): the count of
    # earlier choices of that expert in the row
    flat_eid = eids.reshape(b, s * k)
    onehot = (flat_eid[..., None] == torch.arange(e, device=x.device)).to(torch.int32)
    slot_pos = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)   # (B, S·K)
    return probs, gate_vals, eids, slot_pos, slot_pos < row_capacity(s, cfg)


def _experts(p: Params, x: torch.Tensor, cfg: ArchConfig, gate_vals: torch.Tensor,
             dest: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The combined output (B, S, D) of the ``n_experts`` experts of
    ``p``'s stacks, whose slots ``dest`` (B, S·K) addresses; the dump slot
    ``n_experts · C`` takes every choice they do not run."""
    b, s, d = x.shape
    k, cap = cfg.top_k, row_capacity(s, cfg)
    dest_d = dest[..., None].expand(b, s * k, d)

    # row-local scatter into (B, E·C + 1, D); the last slot takes the overflow
    vals = x.repeat_interleave(k, dim=1).to(cfg.adtype)             # (B, S·K, D)
    buf = torch.zeros((b, n_experts * cap + 1, d), dtype=cfg.adtype, device=x.device)
    buf = buf.scatter(1, dest_d, vals)[:, : n_experts * cap].reshape(b, n_experts, cap, d)

    h = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"])) * \
        torch.einsum("becd,edf->becf", buf, p["w_up"])
    y_e = torch.einsum("becf,efd->becd", h, p["w_down"])             # (B, E, C, D)
    y_flat = F.pad(y_e.reshape(b, n_experts * cap, d), (0, 0, 0, 1))  # dump slot: zeros

    # combine: each choice's slot output, weighted by its gate, summed over k
    slot_out = torch.gather(y_flat, 1, dest_d)
    slot_out = slot_out * gate_vals.reshape(b, s * k, 1).to(slot_out.dtype)
    return slot_out.reshape(b, s, k, d).sum(dim=2).to(cfg.adtype)


def _moe(p: Params, x: torch.Tensor, cfg: ArchConfig, group: Optional[ModelGroup] = None):
    """x (B, S, D) -> (y (B, S, D), router probs (B, S, E), expert ids
    (B, S, K), kept (B, S·K)); over ``group``, each a list a lane."""
    if group is not None:
        return _moe_lanes(p, x, cfg, group)
    e, cap = cfg.n_experts, row_capacity(x.shape[1], cfg)
    probs, gate_vals, eids, slot_pos, keep = _route(p, x, cfg)
    flat_eid = eids.reshape(slot_pos.shape)
    dest = torch.where(keep, flat_eid * cap + slot_pos, torch.full_like(slot_pos, e * cap))
    y = _experts(p, x, cfg, gate_vals, dest, e)
    if cfg.n_shared_experts:
        y = y + L.apply_mlp(p["shared"], x, cfg)
    return y, probs, eids, keep


def _moe_lanes(p: List[Params], x: List[torch.Tensor], cfg: ArchConfig, group: ModelGroup):
    """Experts over ``model``: the route on every lane alike, then each
    lane's experts [lane·E/M, (lane + 1)·E/M) on its copy of x and of the
    gate values, and its columns of the shared experts; one reduce."""
    cap = row_capacity(x[0].shape[1], cfg)
    routes = [_route(pl, xl, cfg) for pl, xl in zip(p, x)]
    xs = tp.copy(group, x)
    gates = tp.copy(group, [r[1] for r in routes])
    shared = ([L.mlp_partial(pl["shared"], xl, cfg) for pl, xl in zip(p, xs)]
              if cfg.n_shared_experts else None)
    partials = []
    for lane, (pl, xl, g, route) in enumerate(zip(p, xs, gates, routes)):
        _, _, eids, slot_pos, keep = route
        a, b = group.piece(cfg.n_experts, lane)
        flat_eid = eids.reshape(slot_pos.shape)
        mine = keep & (flat_eid >= a) & (flat_eid < b)
        dest = torch.where(mine, (flat_eid - a) * cap + slot_pos,
                           torch.full_like(slot_pos, (b - a) * cap))
        y = _experts(pl, xl, cfg, g, dest, b - a)
        partials.append(y if shared is None else y + shared[lane])
    return (tp.reduce(group, partials), [r[0] for r in routes], [r[2] for r in routes],
            [r[4] for r in routes])


def moe_forward(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The MoE layer's output alone: what the serving forward reads (the
    reference computes the metrics there too, and XLA drops them unused)."""
    return _moe(p, x, cfg)[0]


def _metrics(probs: torch.Tensor, eids: torch.Tensor, keep: torch.Tensor, cfg: ArchConfig):
    e = cfg.n_experts
    # the one-hot rows by a comparison, not F.one_hot, whose range check
    # reads the ids on the host (and only on the CPU), so that the program
    # is one on every device and a dry run's trace counts what a run does
    first = eids[..., 0, None] == torch.arange(e, device=eids.device)
    frac_tokens = first.float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux_loss = e * (frac_tokens * frac_probs).sum() * cfg.router_aux_weight
    drop_rate = 1.0 - keep.float().mean()
    return {"moe_aux_loss": aux_loss, "moe_drop_rate": drop_rate}


def apply_moe(p: Params, x: torch.Tensor, cfg: ArchConfig,
              group: Optional[ModelGroup] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (B, S, D) and the metrics: the Switch-style
    load-balance loss (top-1 token share times mean router probability per
    expert) and the share of (token, k) choices dropped past capacity.
    Over ``group`` the output is a list a lane, and each metric a list of
    the lanes' (equal) values."""
    y, probs, eids, keep = _moe(p, x, cfg, group)
    if group is None:
        return y, _metrics(probs, eids, keep, cfg)
    lanes = [_metrics(*route, cfg) for route in zip(probs, eids, keep)]
    return y, {k: [m[k] for m in lanes] for k in lanes[0]}
