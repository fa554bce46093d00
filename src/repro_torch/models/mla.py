"""Multi-head Latent Attention (DeepSeek-V2): the direct prefill form and
the absorbed decode.

Mirrors ``repro/models/mla.py``.  The cache holds only the normed kv
latent ``c_kv`` (rank 512) and the shared rope key ``k_pe`` per position,
plus ``kpos`` (-1 = empty).  Prefill expands the latents into per-head
keys and values (direct form, f32 logits; queries in chunks above the
port's ``ATTN_CHUNK_THRESHOLD``); decode absorbs ``w_uk`` into the query
and ``w_uv`` into the output, so its scores are taken in latent space.

The latent norm is :func:`~repro_torch.models.layers.apply_norm`, so the
``rmsnorm`` kernel on the card.  The attention itself is plain torch, as
the reference's is plain ``jnp.einsum``: q/k dim 192 against v dim 128 fit
no flash-attention call.  The cache writes are in place, as the dense
decoder's are.

Over a model group (``mla_full(group=)``) every lane computes the latents
alike and runs its own heads (its pieces of ``w_q``, ``w_uk`` and
``w_uv``, its rows of ``w_o``) on its copy of them; the lanes' partial
outputs are reduced.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ref
from . import layers as L
from . import parallel as tp
from .common import ArchConfig
from .layers import _spec as spec
from .parallel import ModelGroup

Params = Dict[str, object]

#: query rows a chunk when the prefill is chunked (``repro/models/mla.py``'s
#: ``MLA_CHUNK``)
MLA_CHUNK = 1024


def mla_specs(cfg: ArchConfig) -> Params:
    d, h, pd = cfg.d_model, cfg.n_heads, cfg.param_dtype
    dn, dr, dv, rank = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    return {"w_q": spec((d, h * (dn + dr)), pd), "w_dkv": spec((d, rank), pd),
            "w_kr": spec((d, dr), pd), "kv_norm": L.norm_specs(cfg, rank),
            "w_uk": spec((rank, h, dn), pd), "w_uv": spec((rank, h, dv), pd),
            "w_o": spec((h * dv, d), pd)}


def mla_cache_specs(cfg: ArchConfig, n_layers: int, batch: int, max_len: int) -> Params:
    return {"c_kv": spec((n_layers, batch, max_len, cfg.kv_lora_rank), cfg.dtype),
            "k_pe": spec((n_layers, batch, max_len, cfg.qk_rope_dim), cfg.dtype),
            "kpos": spec((n_layers, batch, max_len), "int32")}


def _q_proj(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
            heads: Optional[int] = None):
    """x (B, S, D) -> q_nope (B, H, S, dn), q_pe (B, H, S, dr) rotated (H:
    ``heads``, a lane's, or the config's)."""
    b, s, _ = x.shape
    h, dn, dr = heads or cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (x @ p["w_q"]).view(b, s, h, dn + dr).transpose(1, 2)
    return q[..., :dn], L.apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _latents(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """x (B, S, D) -> c_kv (B, S, rank) normed, k_pe (B, S, dr) rotated."""
    c_kv = L.apply_norm(p["kv_norm"], x @ p["w_dkv"], cfg)
    k_pe = L.apply_rope((x @ p["w_kr"])[:, None], positions, cfg.rope_theta)[:, 0]
    return c_kv, k_pe


def _attend_block(q_nope, q_pe, k_nope, k_pe, v, q_off: int, scale: float) -> torch.Tensor:
    """One block of queries (B, H, Cq, *) at offset ``q_off`` against every
    key, causal, f32."""
    cq, s_kv = q_nope.shape[2], k_nope.shape[2]
    logits = (torch.einsum("bhsd,bhtd->bhst", q_nope, k_nope)
              + torch.einsum("bhsd,btd->bhst", q_pe, k_pe)) * scale
    q_pos = q_off + torch.arange(cq, device=logits.device)[:, None]
    k_pos = torch.arange(s_kv, device=logits.device)[None, :]
    logits = torch.where(k_pos <= q_pos, logits, torch.full_like(logits, -1e30))
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(logits, dim=-1), v)


def _attend_full(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                 c_kv: torch.Tensor, k_pe: torch.Tensor, heads: Optional[int] = None
                 ) -> torch.Tensor:
    b, s, _ = x.shape
    h, dn, dr, dv = heads or cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_pe = _q_proj(p, x, cfg, positions, h)
    k_nope = torch.einsum("bsr,rhd->bhsd", c_kv, p["w_uk"]).float()
    v = torch.einsum("bsr,rhd->bhsd", c_kv, p["w_uv"]).float()
    qn, qp, kp = q_nope.float(), q_pe.float(), k_pe.float()
    scale = (dn + dr) ** -0.5
    if s < ref.ATTN_CHUNK_THRESHOLD or s % MLA_CHUNK != 0:
        o = _attend_block(qn, qp, k_nope, kp, v, 0, scale)
    else:
        o = torch.cat([_attend_block(qn[:, :, i:i + MLA_CHUNK], qp[:, :, i:i + MLA_CHUNK],
                                     k_nope, kp, v, i, scale)
                       for i in range(0, s, MLA_CHUNK)], dim=2)
    o = o.to(x.dtype).transpose(1, 2).reshape(b, s, h * dv)
    return o @ p["w_o"]


def mla_full(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
             group: Optional[ModelGroup] = None) -> torch.Tensor:
    """Full-sequence causal MLA, direct form.  x: (B, S, D) -> (B, S, D).
    With ``group`` (``p``, ``x`` and ``positions`` a list a lane) each lane
    runs its H/M heads on its copy of the latents, and the lanes' partial
    outputs are reduced."""
    if group is None:
        return _attend_full(p, x, cfg, positions, *_latents(p, x, cfg, positions))
    heads = group.piece(cfg.n_heads, 0)[1]
    lat = [_latents(pl, xl, cfg, pos) for pl, xl, pos in zip(p, x, positions)]
    xs, cs, kps = (tp.copy(group, t) for t in (x, [c for c, _ in lat], [k for _, k in lat]))
    return tp.reduce(group, [_attend_full(pl, xl, cfg, pos, c, k, heads) for pl, xl, pos, c, k
                             in zip(p, xs, positions, cs, kps)])


def mla_prefill(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                layer_cache: Params) -> Tuple[torch.Tensor, Params]:
    """:func:`mla_full` that also writes the latents into the layer's cache
    (positions 0..S-1), in place.  The latents are computed once (the
    reference computes the same values twice)."""
    s = x.shape[1]
    c_kv, k_pe = _latents(p, x, cfg, positions)
    out = _attend_full(p, x, cfg, positions, c_kv, k_pe)
    layer_cache["c_kv"][:, :s].copy_(c_kv)
    layer_cache["k_pe"][:, :s].copy_(k_pe)
    layer_cache["kpos"][:, :s].copy_(positions)
    return out, layer_cache


def mla_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, pos: torch.Tensor,
               layer_cache: Params) -> Tuple[torch.Tensor, Params]:
    """Absorbed one-token decode.  x: (B, 1, D); pos: 0-d int tensor on
    x's device; the new latents are written at position ``pos`` (clamped to
    the cache, as ``dynamic_update_slice`` clamps), in place.  Scores are
    (q_nope · w_uk) · c_kv + q_pe · k_pe in f32; the context is combined in
    latent space and expanded once through ``w_uv``."""
    b = x.shape[0]
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    positions = pos.view(1, 1).expand(b, 1).to(torch.int32)
    q_nope, q_pe = _q_proj(p, x, cfg, positions)                     # (B, H, 1, dn/dr)
    c_new, kpe_new = _latents(p, x, cfg, positions)                  # (B, 1, rank/dr)
    c_kv, k_pe, kpos = layer_cache["c_kv"], layer_cache["k_pe"], layer_cache["kpos"]
    slot = torch.clamp(pos, max=c_kv.shape[1] - 1).view(1).long()
    L.cache_write(c_kv, c_new, slot, 1)
    L.cache_write(k_pe, kpe_new, slot, 1)
    L.cache_write(kpos, positions, slot, 1)

    q_lat = torch.einsum("bhsd,rhd->bhsr", q_nope.float(), p["w_uk"].float())
    cf = c_kv.float()
    logits = (torch.einsum("bhsr,btr->bhst", q_lat, cf)
              + torch.einsum("bhsd,btd->bhst", q_pe.float(), k_pe.float())) * (dn + dr) ** -0.5
    kp = kpos[:, None, None, :]
    logits = torch.where((kp >= 0) & (kp <= pos), logits, torch.full_like(logits, -1e30))
    ctx_lat = torch.einsum("bhst,btr->bhsr", torch.softmax(logits, dim=-1), cf)
    o = torch.einsum("bhsr,rhd->bhsd", ctx_lat, p["w_uv"].float())
    o = o.to(x.dtype).transpose(1, 2).reshape(b, 1, h * dv)
    return o @ p["w_o"], layer_cache
