"""Transformer building blocks of the decoder (dense, MoE, MLA) and Whisper: norms,
rotary embedding, GQA attention (prefill and Whisper's cacheless encoder
attention through the flash-attention kernel, cached single-token decode in
plain torch), MLPs, embeddings.

Mirrors ``repro/models/layers.py``.  Parameters are nested dicts of
tensors.  The training forward's functions (:func:`attention_full`,
:func:`apply_mlp`, :func:`embed_tokens`, :func:`logits_from_hidden`,
:func:`cross_entropy`) also run over the lanes of a model group
(``group=``, :mod:`~repro_torch.models.parallel`): then each parameter
argument is a list of the lanes' pieces and each activation a list of the
lanes' copies.  The norm and attention kernels are called through their
wrappers, which run the hand-written CUDA kernel on CUDA tensors and the
plain version on CPU tensors.  Unlike the JAX functions, the cache writes
here are in place: ``prefill_kv`` and ``attention_decode`` write the
layer's cache tensors (views of the decode-state arena) and return them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.arena import spec_dtype
from repro_torch.core.data import TensorSpec
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from . import parallel as tp
from .common import ArchConfig
from .parallel import ModelGroup

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameter specs (shapes and dtypes; the JAX init_* functions' layout)
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(shape), spec_dtype(dtype))


def norm_specs(cfg: ArchConfig, dim: Optional[int] = None) -> Params:
    d = dim or cfg.d_model
    p = {"scale": _spec((d,), cfg.param_dtype)}
    if cfg.norm == "layernorm":
        p["bias"] = _spec((d,), cfg.param_dtype)
    return p


def attention_specs(cfg: ArchConfig) -> Params:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd = cfg.param_dtype
    p = {"w_q": _spec((d, h * dh), pd), "w_k": _spec((d, hkv * dh), pd),
         "w_v": _spec((d, hkv * dh), pd), "w_o": _spec((h * dh, d), pd)}
    if cfg.qkv_bias:
        p.update(b_q=_spec((h * dh,), pd), b_k=_spec((hkv * dh,), pd),
                 b_v=_spec((hkv * dh,), pd))
    if cfg.qk_norm:
        p["q_norm"] = norm_specs(cfg, dh)
        p["k_norm"] = norm_specs(cfg, dh)
    return p


def mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None) -> Params:
    d, f, pd = cfg.d_model, d_ff or cfg.d_ff, cfg.param_dtype
    if cfg.mlp == "swiglu":
        return {"w_gate": _spec((d, f), pd), "w_up": _spec((d, f), pd),
                "w_down": _spec((f, d), pd)}
    return {"w_up": _spec((d, f), pd), "b_up": _spec((f,), pd),
            "w_down": _spec((f, d), pd), "b_down": _spec((d,), pd)}


def embed_specs(cfg: ArchConfig) -> Params:
    p = {"embedding": _spec((cfg.vocab, cfg.d_model), cfg.param_dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = _spec((cfg.d_model, cfg.vocab), cfg.param_dtype)
    return p


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def apply_norm(p: Params, x: torch.Tensor, cfg: ArchConfig, eps: float = 1e-6) -> torch.Tensor:
    if cfg.norm == "layernorm":
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    return rmsnorm(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# Rotary position embedding (rotate-half)
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) integer."""
    d = x.shape[-1]
    rd = int(d * rotary_pct)
    rd -= rd % 2
    if rd == 0:
        return x
    freqs = rope_freqs(rd, theta, x.device)
    ang = positions[:, None, :, None].float() * freqs           # (B, 1, S, rd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def _project_qkv(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """x (B, S, D) -> q (B, H, S, dh), k and v (B, Hkv, S, dh), each
    contiguous: the norm and flash kernels read them through pointers."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["w_q"]
    k = x @ p["w_k"]
    v = x @ p["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = q.view(b, s, h, dh).transpose(1, 2).contiguous()
    k = k.view(b, s, hkv, dh).transpose(1, 2).contiguous()
    v = v.view(b, s, hkv, dh).transpose(1, 2).contiguous()
    return _norm_rope(p, q, k, cfg, positions) + (v,)


def _norm_rope(p: Params, q: torch.Tensor, k: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor):
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, cfg)
        k = apply_norm(p["k_norm"], k, cfg)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    return q, k


def _heads(t: torch.Tensor, dh: int) -> torch.Tensor:
    """(B, S, n * dh) -> (B, n, S, dh), contiguous."""
    b, s, _ = t.shape
    return t.view(b, s, -1, dh).transpose(1, 2).contiguous()


def kv_heads_of_lane(h: int, hkv: int, lane: int, m: int) -> List[int]:
    """The kv heads that lane ``lane``'s q heads read (its H/M q heads in
    order; query head i meets kv head i // (H / Hkv)): each once where
    they fall in equal consecutive runs (GQA on the lane), else one a
    q head."""
    per, g = h // m, h // hkv
    kv = [(lane * per + i) // g for i in range(per)]
    heads = sorted(set(kv))
    run = per // len(heads)
    if per % len(heads) == 0 and all(kv[i] == heads[i // run] for i in range(per)):
        return heads
    return kv


def _project_qkv_lanes(p: List[Params], x: List[torch.Tensor], cfg: ArchConfig,
                       positions: List[torch.Tensor], group: ModelGroup):
    """Each lane's q, k and v heads (:meth:`ModelGroup.head_split`): its
    own heads; its q heads and the kv heads they read from the gathered k
    and v; or every head, gathered, alike on every lane.  Returns the
    split and the lanes' (q, k, v)."""
    h, hkv, dh, m = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, group.size
    split = group.head_split(h, hkv)
    xs = tp.copy(group, x)
    proj = {w: [xl @ pl[f"w_{w}"] for pl, xl in zip(p, xs)] for w in "qkv"}
    if cfg.qkv_bias:
        proj = {w: [t + pl[f"b_{w}"] for pl, t in zip(p, ts)] for w, ts in proj.items()}
    for w in {"heads": "", "q": "kv", "none": "qkv"}[split]:     # the projections gathered
        proj[w] = tp.gather(group, proj[w])
        if split == "q":                       # each lane reads its own kv heads
            proj[w] = tp.copy(group, proj[w])
    norms = p
    if cfg.qk_norm and split != "none":        # a replicated scale on a lane's heads
        norms = [{"q_norm": a, "k_norm": b} for a, b in zip(
            tp.copy_tree(group, [pl["q_norm"] for pl in p]),
            tp.copy_tree(group, [pl["k_norm"] for pl in p]))]
    out = []
    for lane in range(m):
        q, k, v = (_heads(proj[w][lane], dh) for w in "qkv")
        if split == "q":
            idx = kv_heads_of_lane(h, hkv, lane, m)
            if idx == list(range(idx[0], idx[-1] + 1)):
                k, v = (t[:, idx[0]:idx[-1] + 1].contiguous() for t in (k, v))
            else:
                sel = torch.tensor(idx, device=k.device)
                k, v = (t.index_select(1, sel).contiguous() for t in (k, v))
        q, k = _norm_rope(norms[lane], q, k, cfg, positions[lane])
        out.append((q, k, v))
    return split, out


def attention_full(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, *,
                   causal: bool = True, group: Optional[ModelGroup] = None) -> torch.Tensor:
    """Full-sequence attention with no cache (the decoder's training
    forward; Whisper's encoder: ``causal=False``) through the
    flash-attention kernel.  x: (B, S, D) -> (B, S, D).

    With ``group`` (``p``, ``x`` and ``positions`` each a list a lane),
    each lane runs the kernel on its heads and its rows of ``w_o``, and
    the partial outputs are :func:`~repro_torch.models.parallel.reduce` d;
    where M does not divide H the kernel runs on every head on every
    lane, and each lane takes its rows of the output."""
    if group is not None:
        split, qkv = _project_qkv_lanes(p, x, cfg, positions, group)
        os = [flash_attention(q, k, v, causal=causal, window=cfg.window) for q, k, v in qkv]
        os = [o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1) for o in os]
        if split == "none":
            n = os[0].shape[-1]
            os = [o[..., slice(*group.piece(n, lane))]
                  for lane, o in enumerate(tp.copy(group, os))]
        return tp.reduce(group, [o @ pl["w_o"] for pl, o in zip(p, os)])
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = flash_attention(q, k, v, causal=causal, window=cfg.window)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return o @ p["w_o"]


def kv_cache_specs(cfg: ArchConfig, n_layers: int, batch: int, max_len: int) -> Params:
    """Unified KV cache: ``kpos`` holds each slot's absolute position (-1 =
    empty), so full, sliding-window (rolling buffer) and padded caches all
    use one mask rule: ``0 <= kpos <= pos`` (and inside the window)."""
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    length = min(max_len, cfg.window) if cfg.window else max_len
    return {"k": _spec((n_layers, batch, hkv, length, dh), cfg.dtype),
            "v": _spec((n_layers, batch, hkv, length, dh), cfg.dtype),
            "kpos": _spec((n_layers, batch, length), "int32")}


def cache_write(cache_arr: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
                axis: int) -> torch.Tensor:
    """Write ``new`` (extent 1 on ``axis``) into ``cache_arr`` at ``slot``
    (a (1,) int64 index on the device, so no host sync), in place."""
    return cache_arr.index_copy_(axis, slot, new.to(cache_arr.dtype))


def attention_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, pos: torch.Tensor,
                     layer_cache: Params):
    """One-token decode against a cache.  x: (B, 1, D); pos: 0-d int
    tensor on x's device (the position of this token); layer_cache: k, v
    (B, Hkv, C, dh), kpos (B, C), written in place at slot ``pos % C``.
    Returns (out (B, 1, D), layer_cache)."""
    b = x.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = pos.view(1, 1).expand(b, 1).to(torch.int32)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    k, v, kpos = layer_cache["k"], layer_cache["v"], layer_cache["kpos"]
    slot = torch.remainder(pos, k.shape[2]).view(1).long()
    cache_write(k, k_new, slot, 2)
    cache_write(v, v_new, slot, 2)
    cache_write(kpos, positions, slot, 1)

    # the G = H / Hkv query heads of a KV head side by side: query head
    # i * G + g meets KV head i, the JAX function's jnp.repeat mapping,
    # with no G-fold copy of the cache
    qf = (q.float() * (dh ** -0.5)).view(b, hkv, h // hkv, dh)
    kf, vf = k.float(), v.float()
    logits = torch.einsum("bhgd,bhkd->bhgk", qf, kf)
    kp = kpos[:, None, None, :]
    mask = (kp >= 0) & (kp <= pos)
    if cfg.window:
        mask &= kp > pos - cfg.window
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", probs, vf).to(x.dtype)   # (B, Hkv, G, dh)
    return o.reshape(b, 1, h * dh) @ p["w_o"], layer_cache


def prefill_kv(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
               layer_cache: Params):
    """Full-sequence prefill through the flash-attention kernel that also
    fills the layer's cache in place.  Returns (out, layer_cache)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    out = o @ p["w_o"]
    ck, cv, ckpos = layer_cache["k"], layer_cache["v"], layer_cache["kpos"]
    cache_len = ck.shape[2]
    if cfg.window and s > cache_len:
        # keep only the last `window` keys in the rolling buffer, preserving
        # slot = position mod cache_len so decode continues seamlessly
        start = s - cache_len
        shift = start % cache_len
        ck.copy_(torch.roll(k[:, :, start:].to(ck.dtype), shift, dims=2))
        cv.copy_(torch.roll(v[:, :, start:].to(cv.dtype), shift, dims=2))
        ckpos.copy_(torch.roll(positions[:, start:].to(torch.int32), shift, dims=1))
    else:
        ck[:, :, :s].copy_(k)
        cv[:, :, :s].copy_(v)
        ckpos[:, :s].copy_(positions)
    return out, layer_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_partial(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The MLP without ``b_down``: over a model group, a lane's partial
    output from its columns of the hidden layer."""
    if cfg.mlp == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    h = x @ p["w_up"] + p["b_up"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h, approximate="tanh") if cfg.mlp == "gelu" else torch.square(F.relu(h))
    return h @ p["w_down"]


def apply_mlp(p: Params, x: torch.Tensor, cfg: ArchConfig,
              group: Optional[ModelGroup] = None) -> torch.Tensor:
    """The MLP; with ``group``, each lane's :func:`mlp_partial` on its copy
    of x, reduced, then ``b_down`` added once."""
    if group is not None:
        ys = tp.reduce(group, [mlp_partial(pl, xl, cfg) for pl, xl in zip(p, tp.copy(group, x))])
        return ys if cfg.mlp == "swiglu" else [y + pl["b_down"] for pl, y in zip(p, ys)]
    y = mlp_partial(p, x, cfg)
    return y if cfg.mlp == "swiglu" else y + p["b_down"]


# ---------------------------------------------------------------------------
# Embeddings / logits
# ---------------------------------------------------------------------------

def embed_tokens(p: Params, tokens: torch.Tensor, cfg: ArchConfig,
                 group: Optional[ModelGroup] = None) -> torch.Tensor:
    """The tokens' embedding rows through ``F.embedding``, whose CUDA
    backward sums the rows of repeated tokens in a fixed order (no float
    atomics), so a training step's gradient is the same on every run.
    With ``group``, the vocabulary-parallel lookup
    (:func:`~repro_torch.models.parallel.embed`)."""
    if group is not None:
        return tp.embed(group, tokens, [pl["embedding"] for pl in p], cfg.adtype)
    return F.embedding(tokens.long(), p["embedding"]).to(cfg.adtype)


def logits_from_hidden(p: Params, x: torch.Tensor, cfg: ArchConfig,
                       group: Optional[ModelGroup] = None) -> torch.Tensor:
    """f32 logits; with ``group``, each lane's columns of its vocabulary
    rows ``(..., V/M)``."""
    if group is not None:
        return [logits_from_hidden(pl, xl, cfg) for pl, xl in zip(p, tp.copy(group, x))]
    if cfg.tie_embeddings:
        return (x @ p["embedding"].T.to(cfg.adtype)).float()
    return (x @ p["unembed"]).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  group: Optional[ModelGroup] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V) f32, labels (...) int.
    With ``mask`` (...), the mean over the positions it weights.  With
    ``group``, ``logits`` holds each lane's columns and the loss is the
    vocabulary-parallel one (:func:`~repro_torch.models.parallel.
    cross_entropy`)."""
    if group is not None:
        return tp.cross_entropy(group, logits, labels, mask)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
