"""Mamba2 block (state-space duality, SSD) in its chunked-scan form: the
mixer of Zamba2's backbone.

Mirrors ``repro/models/mamba2.py``.  Full sequence: the published chunked
SSD algorithm, intra-chunk "attention" with the segment-sum decay matrix
and the inter-chunk state recurrence, a loop over the chunks.  Decode: the
O(1) recurrent update of the (heads, head_dim, state) tensor and the
rolling conv window.  The SSD runs in plain f32 torch, as the reference's
runs in plain ``jnp`` (it has no Pallas kernel); the gated RMS norm is
computed inline in f32, as the reference computes it.

Every contraction is a two-operand einsum, the reference's ``local=True``
form (numerically the same function as its default 3- and 4-operand
einsums): torch contracts a many-operand einsum left to right, and that
order would build intermediates far larger than the (b, nc, h, q, q)
decay matrix, the largest tensor here.

Unlike the reference's, :func:`mamba2_step` writes the state it is given
in place (the conv window shifted by one row, the SSM state), so a
captured decode step updates the decode-state arena's views.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import parallel as tp
from .common import MODEL, ArchConfig, Rules, alloc_tree, init_tree, tree_flatten
from .layers import _spec as spec
from .parallel import ModelGroup

Params = Dict[str, Any]


def dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_ssm_heads, head_dim, conv_channels)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_head_dim
    nh = d_inner // hd
    conv_ch = d_inner + 2 * cfg.ssm_state  # x + B + C (n_groups = 1)
    return d_inner, nh, hd, conv_ch


def mamba2_specs(cfg: ArchConfig) -> Params:
    """One layer's parameters, as ``init_mamba2`` of the JAX package lays
    them out (``A_log``, ``D`` and ``dt_bias`` float32, the rest
    ``param_dtype``)."""
    d, pd = cfg.d_model, cfg.param_dtype
    d_inner, nh, hd, conv_ch = dims(cfg)
    d_in_proj = 2 * d_inner + 2 * cfg.ssm_state + nh  # z, xBC, dt
    return {"in_proj": spec((d, d_in_proj), pd),
            "conv_w": spec((cfg.ssm_conv, conv_ch), pd),
            "conv_b": spec((conv_ch,), pd),
            "A_log": spec((nh,), "float32"),
            "D": spec((nh,), "float32"),
            "dt_bias": spec((nh,), "float32"),
            "norm_scale": spec((d_inner,), pd),
            "out_proj": spec((d_inner, d), pd)}


def init_mamba2(generator: torch.Generator, cfg: ArchConfig, *, device=None) -> Params:
    """Random parameters of one layer, each leaf by its role
    (:func:`~repro_torch.models.common.init_leaf_`): ``A_log`` and
    ``dt_bias`` 0, ``D`` and ``norm_scale`` 1, ``conv_b`` 0, the
    projections and the conv taps N(0, fan_in^-1/2)."""
    return init_tree(mamba2_specs(cfg), generator, device=device)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) with [i, j] = sum_{k=j+1..i} x_k, -inf
    above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, chunk: int, h0: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, h, p); dt: (b, s, h) after the softplus; A: (h,) negative;
    B, C: (b, s, n); h0: (b, h, p, n) or None.  Returns (y (b, s, h, p),
    final state (b, h, p, n) f32)."""
    b, s, nh, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    s_pad = -(-s // q) * q
    if s_pad != s:
        # zero-pad time: dt = 0 makes the padded steps exact identities
        # (decay exp(0) = 1, no contribution to the state or the output)
        x = F.pad(x, (0, 0, 0, 0, 0, s_pad - s))
        dt, B, C = (F.pad(t, (0, 0, 0, s_pad - s)) for t in (dt, B, C))
    nc = s_pad // q
    xc = x.reshape(b, nc, q, nh, p)
    dtc = dt.reshape(b, nc, q, nh)
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)
    dA = dtc * A                                          # (b, nc, q, h)
    dA_cs = torch.cumsum(dA, dim=2)

    # 1) intra-chunk (diagonal blocks): causal "attention" with the decay kernel
    Lmat = torch.exp(_segsum(dA.transpose(-1, -2)))       # (b, nc, h, q, q)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)      # (b, nc, q, q)
    M = Lmat * scores[:, :, None]                         # (b, nc, h, i, j)
    del Lmat
    Xdt = xc * dtc[..., None]                             # (b, nc, j, h, p)
    y = torch.einsum("bchij,bcjhp->bcihp", M, Xdt)
    del M, Xdt

    # 2) each chunk's end state
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b, nc, q, h)
    Xw = xc * (decay_states * dtc)[..., None]             # (b, nc, j, h, p)
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc, Xw)    # (b, nc, h, p, n)

    # 3) inter-chunk recurrence, the state before each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])           # (b, nc, h)
    h = (torch.zeros((b, nh, p, n), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]

    # 4) the states' contribution to the outputs
    y_off = torch.einsum("bcin,bchpn->bcihp", Cc, torch.stack(h_prevs, dim=1))
    y = y + y_off * torch.exp(dA_cs)[..., None]
    return y.reshape(b, s_pad, nh, p)[:, :s], h


def _split_proj(zxbcdt: torch.Tensor, cfg: ArchConfig):
    d_inner, nh, hd, conv_ch = dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: d_inner + conv_ch]
    dt = zxbcdt[..., d_inner + conv_ch:]
    return z, xbc, dt


def _gate(D: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
          x_in: torch.Tensor) -> torch.Tensor:
    """The D skip and the SiLU gate in f32: (..., heads x head_dim)."""
    y = y + D[:, None] * x_in                             # skip connection
    return y.reshape(*y.shape[:-2], -1) * F.silu(z.float())


def _gated_out(p: Params, y: torch.Tensor, z: torch.Tensor, x_in: torch.Tensor,
               cfg: ArchConfig, eps: float = 1e-6) -> torch.Tensor:
    """D skip, the SiLU gate and the gated RMS norm in f32 (inline, not the
    rmsnorm kernel: the reference's math), then the output projection."""
    y = _gate(p["D"], y, z, x_in)
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + eps) * p["norm_scale"].float()
    return y.to(cfg.adtype) @ p["out_proj"]


def _ssd_of(zxbcdt: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
            dt_bias: torch.Tensor, A_log: torch.Tensor, cfg: ArchConfig,
            h0: Optional[torch.Tensor] = None):
    """The causal conv and the chunked SSD of the heads whose ``z``, ``x``
    and ``dt`` columns (with the ``B`` and ``C`` every head shares)
    ``zxbcdt`` holds, ``in_proj``'s layout for ``len(dt_bias)`` heads;
    ``conv_w`` and ``conv_b`` their conv channels.  Returns (y (B, S, heads,
    head_dim), z, the conv input x in f32, the conv window a decode step
    continues from, the final SSM state)."""
    b, s, _ = zxbcdt.shape
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    nh = dt_bias.shape[0]
    di = nh * hd
    z, xbc, dt = zxbcdt[..., :di], zxbcdt[..., di: 2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]

    # causal depthwise conv over time, kernel ssm_conv
    pad = F.pad(xbc, (0, 0, cfg.ssm_conv - 1, 0))
    conv = sum(pad[:, i: i + s, :] * conv_w[i] for i in range(cfg.ssm_conv))
    act = F.silu((conv + conv_b).float()).to(cfg.adtype)

    xs = act[..., :di].reshape(b, s, nh, hd).float()
    Bm = act[..., di: di + n].float()
    Cm = act[..., di + n:].float()
    dt = F.softplus(dt.float() + dt_bias)
    A = -torch.exp(A_log)
    y, h_t = _ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk, h0)
    return y, z, xs, pad[:, s:], h_t


def mamba2_scan(p: Params, x: torch.Tensor, cfg: ArchConfig,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence forward from SSM state ``h0`` (zeros when None) and a
    zero conv history.  x: (B, S, D).  Returns (out (B, S, D), the conv
    window a decode step continues from (B, ssm_conv - 1, conv_ch): the
    last ssm_conv - 1 pre-activation conv inputs, the zero history in
    front of a shorter prompt, as stepping from a zero window leaves it;
    the final SSM state (B, nh, hd, N) f32)."""
    y, z, xs, window, h_t = _ssd_of(x @ p["in_proj"], p["conv_w"], p["conv_b"], p["dt_bias"],
                                    p["A_log"], cfg, h0)
    return _gated_out(p, y, z, xs, cfg), window, h_t


def mamba2_forward(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence forward from a zero state.  x: (B, S, D) -> (B, S, D)."""
    return mamba2_scan(p, x, cfg)[0]


def lane_columns(cfg: ArchConfig, group: ModelGroup) -> List[List[Tuple[int, int]]]:
    """The ``in_proj`` columns each lane of ``group`` needs for its heads
    (:meth:`~repro_torch.models.parallel.ModelGroup.piece` of the SSD's
    heads): its ``z``, its ``x``, the shared ``B`` and ``C``, its ``dt``, in
    ``in_proj``'s order."""
    d_inner, nh, hd, _ = dims(cfg)
    bc = (2 * d_inner, 2 * d_inner + 2 * cfg.ssm_state)
    return [[(a * hd, b * hd), (d_inner + a * hd, d_inner + b * hd), bc, (bc[1] + a, bc[1] + b)]
            for a, b in (group.piece(nh, lane) for lane in range(group.size))]


def mamba2_forward_lanes(p: List[Params], x: List[torch.Tensor], cfg: ArchConfig,
                         group: ModelGroup, eps: float = 1e-6) -> List[torch.Tensor]:
    """:func:`mamba2_forward` over a model group's lanes (``p`` each lane's
    pieces, ``x`` each lane's copy): the SSD runs on each lane's heads.
    ``in_proj``'s contiguous column pieces do not line up with the heads,
    so its products are redistributed (:func:`~repro_torch.models.parallel.
    regroup`, :func:`lane_columns`) into each lane's ``z``, ``x`` and ``dt``
    and the ``B`` and ``C`` every lane convolves alike; the replicated conv
    taps, ``D``, ``A_log``, ``dt_bias`` and ``norm_scale`` reach a lane's
    channels through ``copy`` / ``split``; the gated norm's sum of squares
    over the whole ``d_inner`` is summed over the lanes both ways
    (:func:`~repro_torch.models.parallel.allreduce`); each lane's rows of
    ``out_proj`` give a partial output, reduced."""
    d_inner, nh, hd, _ = dims(cfg)
    heads = [group.piece(nh, lane) for lane in range(group.size)]
    zx = tp.regroup(group, [xl @ pl["in_proj"] for pl, xl in zip(p, tp.copy(group, x))],
                    lane_columns(cfg, group))

    def own(t, a, b):               # a lane's x conv channels, then B and C
        return torch.cat([t[..., a * hd: b * hd], t[..., d_inner:]], -1)

    conv_w, conv_b = (tp.copy(group, tp.sub(p, k)) for k in ("conv_w", "conv_b"))
    dt_bias, A_log, D, scale = (tp.split(group, tp.sub(p, k), 0)
                                for k in ("dt_bias", "A_log", "D", "norm_scale"))
    ys = []
    for lane, (a, b) in enumerate(heads):
        y, z, xs, _, _ = _ssd_of(zx[lane], own(conv_w[lane], a, b), own(conv_b[lane], a, b),
                                 dt_bias[lane], A_log[lane], cfg)
        ys.append(_gate(D[lane], y, z, xs))
    sums = tp.allreduce(group, [(y * y).sum(dim=-1, keepdim=True) for y in ys])
    return tp.reduce(group, [
        (y * torch.rsqrt(ss / d_inner + eps) * sc.float()).to(cfg.adtype) @ pl["out_proj"]
        for pl, y, ss, sc in zip(p, ys, sums, scale)])


def mamba2_state_specs(cfg: ArchConfig, batch: int) -> Params:
    """A layer's decode state: the conv window (activation dtype) and the
    SSM state (float32)."""
    d_inner, nh, hd, conv_ch = dims(cfg)
    return {"conv": spec((batch, cfg.ssm_conv - 1, conv_ch), cfg.dtype),
            "ssm": spec((batch, nh, hd, cfg.ssm_state), "float32")}


def init_mamba2_state(cfg: ArchConfig, batch: int, device=None) -> Params:
    state = alloc_tree(mamba2_state_specs(cfg, batch), device)
    for _, t in tree_flatten(state):
        t.zero_()
    return state


def mamba2_step(p: Params, x: torch.Tensor, cfg: ArchConfig,
                state: Params) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  x: (B, 1, D); state: {conv, ssm}, written in
    place and returned."""
    b = x.shape[0]
    d_inner, nh, hd, conv_ch = dims(cfg)
    z, xbc, dt = _split_proj(x @ p["in_proj"], cfg)     # xbc: (B, 1, conv_ch)

    window = torch.cat([state["conv"], xbc.to(state["conv"].dtype)], dim=1)
    conv = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    xbc_t = F.silu(conv)                                  # (B, conv_ch)
    state["conv"].copy_(window[:, 1:])

    xt = xbc_t[:, :d_inner].reshape(b, nh, hd)
    Bt = xbc_t[:, d_inner: d_inner + cfg.ssm_state]
    Ct = xbc_t[:, d_inner + cfg.ssm_state:]
    dtt = F.softplus(dt[:, 0].float() + p["dt_bias"])    # (B, nh)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dtt * A)                            # (B, nh)
    ssm = state["ssm"] * decay[..., None, None] \
        + (dtt[..., None] * xt)[..., None] * Bt[:, None, None, :]
    state["ssm"].copy_(ssm)
    y = torch.einsum("bhpn,bn->bhp", ssm, Ct)             # (B, nh, hd)
    return _gated_out(p, y[:, None], z, xt[:, None], cfg), state


def mamba2_partition_rules(prefix: str = "") -> Rules:
    """The JAX package's rule table of one Mamba2 layer."""
    return [
        (prefix + r"in_proj", (None, MODEL)),
        (prefix + r"conv_w|conv_b", ()),
        (prefix + r"out_proj", (MODEL, None)),
        (prefix + r"A_log|dt_bias|norm_scale", ()),
    ]
