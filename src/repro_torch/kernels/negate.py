"""Negate (intensity inversion), the paper's listing 4:
``output[i] = 1.0 - input[i]``, computed in f32 and stored in x's dtype.

On CUDA tensors it is the hand-written ``negate_kernel``
(``csrc/negate_kernels.cu``: a grid-stride loop over batches of four
16-byte vectors per thread, all loaded before the first store, or of one
where four would leave SMs without a block, and a scalar tail; a
misaligned view takes a scalar loop), replacing the Pallas kernel of
``repro/kernels/negate.py``; on CPU tensors it is the plain version
:func:`.ref.negate`.  Bit-exact against the plain version in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import Cost, count_launch, kernel
from . import _build, ref
from .common import (check_cuda, check_in_place, check_out, counting, launch, nbytes,
                     out_or_empty, traced)

DTYPES = (torch.float32, torch.bfloat16)


def negate(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``1 - x`` of any shape; ``out`` (x's shape and dtype) may be ``x``
    itself or an arena view."""
    if x.is_meta or counting():
        return traced("negate_kernel", lambda: negate(x, out),
                      lambda: out_or_empty(out, x.shape, x.dtype, x.device), x, out)
    if x.device.type == "cpu":
        res = ref.negate(x)
        return res if out is None else out.copy_(res)
    check_cuda("x", x, DTYPES, aligned=False)
    if out is None:
        out = torch.empty_like(x)
    else:
        check_out(out, x.shape, x.dtype, x.device)
        check_in_place(out, x)
    err = launch(_build.library().rt_negate, x, x.data_ptr(), out.data_ptr(), x.numel(),
                 int(x.dtype == torch.bfloat16))
    _build.check(err, "negate")
    count_launch("negate_kernel")
    return out


def negate_cost(x: torch.Tensor, out=None) -> Cost:
    """Read x, write its shape; one flop an element."""
    return Cost(x.numel(), 2 * nbytes(x))


kernel("negate_kernel", ref=ref.negate, cost=negate_cost)(negate)
