"""RMS norm over the last axis (LM hot path): ``x * rsqrt(mean(x²) + eps)
* w`` in f32, output in x's dtype.

On CUDA tensors it is the hand-written ``rmsnorm_kernel``
(``csrc/lm_kernels.cu``: one warp per row, 16-byte loads, warp-shuffle
sum), replacing the Pallas kernel of ``repro/kernels/rmsnorm.py``; on CPU
tensors it is the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core.registry import count_launch, kernel
from . import _build, ref
from .common import check_cuda, launch_stream

DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); weight: (D,).  Matches :func:`ref.rmsnorm`."""
    if x.ndim < 1 or tuple(weight.shape) != (x.shape[-1],):
        raise ValueError(f"weight {tuple(weight.shape)} does not match x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.rmsnorm(x, weight, eps)
    check_cuda("x", x, DTYPES)
    check_cuda("weight", weight, DTYPES, device=x.device)
    d = int(x.shape[-1])
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _build.library().rt_rmsnorm(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
            int(x.dtype == torch.bfloat16), int(weight.dtype == torch.bfloat16), float(eps),
            launch_stream(x))
    _build.check(err, "rmsnorm")
    count_launch("rmsnorm")
    return out


kernel("rmsnorm", ref=ref.rmsnorm)(rmsnorm)
