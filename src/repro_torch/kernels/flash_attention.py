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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import Cost, count_launch, kernel
from . import _build, ref
from .common import check_cuda, launch, nbytes

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 64, 80, 128)  # the kernel's template instances (16: the SMOKE configs)
MAX_GRID_YZ = 65535            # batch rides on gridDim.z; query heads (f32) or
                               # 64-query tiles (bf16) on gridDim.y


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); Hq % Hkv == 0."""
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"need q (B,Hq,Sq,D) and k, v (B,Hkv,Skv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if scale is None:
        scale = d ** -0.5
    if q.is_cpu:
        return ref.attention(q, k, v, causal=causal, window=window, scale=scale)
    check_cuda("q", q, DTYPES)
    for name, t in (("k", k), ("v", v)):
        check_cuda(name, t, (q.dtype,), device=q.device)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIMS}")
    if hq > MAX_GRID_YZ or b > MAX_GRID_YZ or -(-sq // 64) > MAX_GRID_YZ:
        raise ValueError(f"{b} batches x {hq} heads x {sq} queries exceed the kernel's grid")
    out = torch.empty_like(q)
    err = launch(_build.library().rt_flash_attention, q, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, k.shape[2], d, causal,
                 window or 0, scale, q.dtype == torch.bfloat16)
    _build.check(err, "flash_attention")
    count_launch("flash_attention")
    return out


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


kernel("flash_attention", ref=ref.attention, cost=flash_attention_cost)(flash_attention)
