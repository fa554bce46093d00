"""RMS norm over the last axis (LM hot path): ``x * rsqrt(mean(x²) + eps)
* w`` in f32, output in x's dtype.

On CUDA tensors it is the hand-written one-pass ``rmsnorm_kernel`` family
(``csrc/lm_kernels.cu``: each row read once into registers in 16-byte
vectors, the thread count per row chosen by its width), replacing the
Pallas kernel of ``repro/kernels/rmsnorm.py``; on CPU tensors it is the
plain version in :mod:`.ref`.  The wrapper runs at every norm of every
layer (161 calls a qwen3-14b decode step), so its host path is kept short:
see :func:`.common.launch`.
"""
from __future__ import annotations

import torch

from repro_torch.core.registry import Cost, count_launch, kernel
from . import _build, ref
from .common import check_cuda, launch, nbytes

DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); weight: (D,).  Matches :func:`ref.rmsnorm`."""
    if x.ndim < 1 or weight.shape != x.shape[-1:]:
        raise ValueError(f"weight {tuple(weight.shape)} does not match x {tuple(x.shape)}")
    if x.is_cpu:
        return ref.rmsnorm(x, weight, eps)
    check_cuda("x", x, DTYPES)
    check_cuda("weight", weight, DTYPES, device=x.device)
    d = x.shape[-1]
    out = torch.empty_like(x)
    err = launch(_build.library().rt_rmsnorm, x, x.data_ptr(), weight.data_ptr(),
                 out.data_ptr(), x.numel() // d if d else 0, d, x.dtype == torch.bfloat16,
                 weight.dtype == torch.bfloat16, eps)
    _build.check(err, "rmsnorm")
    count_launch("rmsnorm")
    return out


def rmsnorm_cost(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> Cost:
    """Read x and the weight, write x's shape; 4 flops an element (square,
    sum, scale, weight), held to the bf16 tensor rate for bf16 rows."""
    peak = "bf16_tensor" if x.dtype == torch.bfloat16 else "fp32"
    return Cost(4 * x.numel(), 2 * nbytes(x) + nbytes(weight), peak)


kernel("rmsnorm", ref=ref.rmsnorm, cost=rmsnorm_cost)(rmsnorm)
