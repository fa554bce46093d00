"""Attention with an online softmax (prefill hot path): GQA, causal and
sliding-window masks, queries aligned to the end of the keys, rows that
see no key -> 0.

On CUDA tensors it is the hand-written ``flash_kernel``
(``csrc/lm_kernels.cu``: one block per 64-query tile and query head, key
tiles of 32 in shared memory, masked tiles skipped, ragged edges masked in
the kernel, f32 accumulation), replacing the Pallas kernel of
``repro/kernels/flash_attention.py``; on CPU tensors it is the plain
version :func:`.ref.attention`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import count_launch, kernel
from . import _build, ref
from .common import check_cuda, launch_stream

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 80, 128)      # the kernel's template instances
MAX_GRID_YZ = 65535            # query heads ride on gridDim.y, batch on z


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
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window, scale=scale)
    check_cuda("q", q, DTYPES)
    for name, t in (("k", k), ("v", v)):
        check_cuda(name, t, (q.dtype,), device=q.device)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIMS}")
    if hq > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"{b} batches x {hq} heads exceed the kernel's grid")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.library().rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, sq,
            k.shape[2], d, int(causal), int(window or 0), float(scale),
            int(q.dtype == torch.bfloat16), launch_stream(q))
    _build.check(err, "flash_attention")
    count_launch("flash_attention")
    return out


kernel("flash_attention", ref=ref.attention)(flash_attention)
