"""Attention with an online softmax (prefill hot path): GQA, causal and
sliding-window masks, queries aligned to the end of the keys, rows that
see no key -> 0.

On CUDA tensors it is a hand-written kernel of ``csrc/lm_kernels.cu``,
replacing the Pallas kernel of ``repro/kernels/flash_attention.py``: for
bf16 ``flash_mma_kernel`` on the tensor cores (``mma.sync`` m16n8k16,
bf16 operands, f32 softmax statistics and sums, P rounded to bf16 for the
P·V product), for f32 ``flash_fma_kernel`` on the f32 FMA units (exact f32,
no TF32).  Both take one block per 64-query tile and query head, skip key
tiles that no query of the block sees and mask the ragged edges
themselves.  On CPU tensors it is the plain version :func:`.ref.attention`.

When autograd needs a gradient of a CUDA call (a training forward), the
call goes through :class:`FlashAttentionFn`: its forward also writes each
row's log-sum-exp (the output is the same bit for bit), and its backward
is hand-written kernels with no float atomics, so the gradients are the
same on every run.  For bf16, three kernels on the tensor cores:
``flash_bwd_delta_kernel`` (rowsum(dO o) once, into a scratch),
``flash_bwd_mma_dkdv_kernel`` (a block per 64-key tile and KV head in the
transposed form, walking the query tiles and heads of its group in a fixed
order, P^T and dS^T kept in registers as the A operands of dV and dK) and
``flash_bwd_mma_dq_kernel`` (a block per 64-query tile and head, the
forward's shape); for f32, ``flash_bwd_dkdv_kernel`` and
``flash_bwd_dq_kernel`` on the FMA units, 32-key and 32-query tiles.
The JAX package trains through plain ``jnp``, so the gradient has no
Pallas kernel to replace; its plain version is autograd through
:func:`.ref.attention`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import Cost, count_launch, kernel
from . import _build, ref
from .common import check_cuda, counting, launch, nbytes, traced

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 64, 80, 128)  # the kernel's template instances (16: the SMOKE configs)
MAX_GRID_YZ = 65535            # batch rides on gridDim.z; query heads (f32
                               # forward) or query tiles (the others) on
                               # gridDim.y, and key tiles too (bf16 backward)
#: query and key tiles of the backward kernels (kBwdMmaTile, kBwdTile)
BWD_TILE = {torch.bfloat16: 64, torch.float32: 32}


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int]) -> None:
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"need q (B,Hq,Sq,D) and k, v (B,Hkv,Skv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def _check_cuda_inputs(q: torch.Tensor, *others: torch.Tensor, tile: int = 64) -> None:
    """Raise unless the inputs suit a kernel whose query tiles of ``tile``
    rows ride on gridDim.y (64 the forward's, :data:`BWD_TILE` the
    backward's)."""
    b, hq, sq, d = q.shape
    check_cuda("q", q, DTYPES)
    for i, t in enumerate(others):
        check_cuda(f"input {i + 1}", t, (q.dtype,), device=q.device)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIMS}")
    if hq > MAX_GRID_YZ or b > MAX_GRID_YZ or -(-sq // tile) > MAX_GRID_YZ:
        raise ValueError(f"{b} batches x {hq} heads x {sq} queries exceed the kernel's grid")


def _forward(q, k, v, causal, window, scale, with_lse: bool):
    """The forward kernel; with ``with_lse`` also each row's log-sum-exp
    (B, Hq, Sq) f32 (natural log of the scaled scores; +inf for a row
    that sees no key).  On CPU tensors the plain version, with no
    log-sum-exp (its backward needs none)."""
    if q.is_meta or counting():
        def empty():
            lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
                   if with_lse else None)
            return torch.empty_like(q), lse
        return traced("flash_attention", lambda: _forward(q, k, v, causal, window, scale, with_lse),
                      empty, q, k, v, causal=causal, window=window, scale=scale)
    if q.is_cpu:
        return ref.attention(q, k, v, causal=causal, window=window, scale=scale), None
    _check_cuda_inputs(q, k, v)
    b, hq, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    err = launch(_build.library().rt_flash_attention, q, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None, b, hq,
                 k.shape[1], sq, k.shape[2], d, causal, window or 0, scale,
                 q.dtype == torch.bfloat16)
    _build.check(err, "flash_attention")
    count_launch("flash_attention")
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` on CUDA tensors with the hand-written
    backward (on ``meta`` tensors, and under a counting mode on CPU ones,
    with the entries' costs)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = _forward(q, k, v, causal, window, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, causal=causal,
                                         window=window, scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); Hq % Hkv == 0."""
    _check_shapes(q, k, v, window)
    if scale is None:
        scale = q.shape[3] ** -0.5
    if q.is_cpu and not counting():
        return ref.attention(q, k, v, causal=causal, window=window, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale, with_lse=False)[0]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, lse: Optional[torch.Tensor], *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None):
    """(dq, dk, dv) of :func:`flash_attention` for the output gradient
    ``dout``, given the forward's output ``out`` and log-sum-exp ``lse``
    (what :class:`FlashAttentionFn` saves).  Matches
    :func:`ref.attention_bwd`, which takes and needs neither."""
    _check_shapes(q, k, v, window)
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(q.shape):
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be q's "
                         f"shape {tuple(q.shape)}")
    if scale is None:
        scale = q.shape[3] ** -0.5
    if q.is_meta or counting():
        return traced("flash_attention_bwd",
                      lambda: flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                                  window=window, scale=scale),
                      lambda: (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)),
                      q, k, v, out, dout, lse, causal=causal, window=window, scale=scale)
    if q.is_cpu:
        return ref.attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window,
                                 scale=scale)
    tile = BWD_TILE.get(q.dtype, 32)
    _check_cuda_inputs(q, k, v, out, dout, tile=tile)
    b, hq, sq, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    if bf16 and -(-k.shape[2] // tile) > MAX_GRID_YZ:
        raise ValueError(f"{k.shape[2]} keys exceed the backward kernel's grid")
    if lse is None or lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse: need the forward's ({b}, {hq}, {sq}) f32 log-sum-exp")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # rowsum(dout o) for the bf16 kernels (the f32 ones compute it themselves)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if bf16 else None
    err = launch(_build.library().rt_flash_attention_bwd, q, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 delta.data_ptr() if bf16 else None, dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, hq, k.shape[1], sq, k.shape[2], d, causal, window or 0,
                 scale, bf16)
    _build.check(err, "flash_attention_bwd")
    count_launch("flash_attention_bwd")
    return dq, dk, dv


def visible_pairs(sq: int, skv: int, causal: bool, window: Optional[int]) -> int:
    """Query-key pairs attention computes: each query i (at position
    i + skv - sq) sees keys up to itself (causal) and above its window."""
    qpos = torch.arange(sq, dtype=torch.int64) + skv - sq
    hi = torch.minimum(qpos, torch.tensor(skv - 1)) if causal else torch.full((sq,), skv - 1)
    lo = (torch.clamp(qpos - window + 1, min=0) if window
          else torch.zeros(sq, dtype=torch.int64))
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def flash_attention_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None) -> Cost:
    """Read q, k, v, write q's shape; 4 D flops a visible query-key pair
    and query head (q k and p v), held to the bf16 tensor rate for bf16
    inputs (the tensor-core kernel), else fp32 (the FMA kernel)."""
    b, hq, sq, d = q.shape
    pairs = visible_pairs(sq, k.shape[2], causal, window)
    peak = "bf16_tensor" if q.dtype == torch.bfloat16 else "fp32"
    return Cost(4 * b * hq * d * pairs, 2 * nbytes(q) + nbytes(k) + nbytes(v), peak)


def flash_attention_bwd_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, dout: torch.Tensor, lse=None, *,
                             causal: bool = True, window: Optional[int] = None,
                             scale: Optional[float] = None) -> Cost:
    """Read q, k, v, out, dout and lse, write dq, dk and dv; 10 D flops a
    visible query-key pair and query head (s and dp recomputed, dv, dk and
    dq), held to the bf16 tensor rate for bf16 inputs, else fp32."""
    b, hq, sq, d = q.shape
    pairs = visible_pairs(sq, k.shape[2], causal, window)
    peak = "bf16_tensor" if q.dtype == torch.bfloat16 else "fp32"
    moved = 4 * nbytes(q) + 2 * (nbytes(k) + nbytes(v)) + 4 * b * hq * sq
    return Cost(10 * b * hq * d * pairs, moved, peak)


kernel("flash_attention", ref=ref.attention, cost=flash_attention_cost)(flash_attention)
kernel("flash_attention_bwd", ref=ref.attention_bwd,
       cost=flash_attention_bwd_cost)(flash_attention_bwd)
