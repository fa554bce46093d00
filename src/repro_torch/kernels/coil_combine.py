"""Coil combination: xImageSum (paper §IV-A) and RSS (§IV-B).

Both reduce the coil axis of a (..., C, H, W) stack:

* ``ximage_sum``: complex sum over coils (final step of eq. 1)
* ``rss``: root-sum-of-squares magnitude, float32 (the Table I/II op)

For CUDA tensors they launch ``coil_combine_kernel`` (``csrc/mri_kernels.cu``);
for CPU tensors they run the plain versions in :mod:`.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core.registry import Cost, count_launch, kernel
from . import _build, ref
from .common import (check_complex64, check_out, coil_grid, counting, launch, nbytes,
                     out_or_empty, traced)


def _combine(x: torch.Tensor, rss: bool, out: torch.Tensor | None) -> torch.Tensor:
    f, c, h, w = coil_grid(x)
    if x.is_meta or counting():
        return traced("rss" if rss else "xImageSum", lambda: _combine(x, rss, out),
                      lambda: out_or_empty(out, tuple(x.shape[:-3]) + (h, w),
                                           torch.float32 if rss else torch.complex64, x.device),
                      x, out)
    if x.device.type == "cpu":
        res = ref.rss(x) if rss else ref.ximage_sum(x)
        return res if out is None else out.copy_(res)
    check_complex64("x", x)
    shape = tuple(x.shape[:-3]) + (h, w)
    dtype = torch.float32 if rss else torch.complex64
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=x.device)
    else:
        check_out(out, shape, dtype, x.device)
    err = launch(_build.library().rt_coil_combine, x, x.data_ptr(), out.data_ptr(), int(rss),
                 f, c, h * w)
    name = "rss" if rss else "xImageSum"
    _build.check(err, name)
    count_launch(name)
    return out


def ximage_sum(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Sum over the coil axis of (..., C, H, W)."""
    return _combine(x, False, out)


def rss(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Root-sum-of-squares over the coil axis of (..., C, H, W) -> f32."""
    return _combine(x, True, out)


def _combine_cost(x: torch.Tensor, out_itemsize: int, flops_each: int) -> Cost:
    """Read the coil stack once, write one image a frame."""
    return Cost(flops_each * x.numel(), nbytes(x) + x.numel() // x.shape[-3] * out_itemsize)


def ximage_sum_cost(x: torch.Tensor, out=None) -> Cost:
    """2 flops an element (a complex add); a complex64 image out."""
    return _combine_cost(x, 8, 2)


def rss_cost(x: torch.Tensor, out=None) -> Cost:
    """4 flops an element (|z|^2 and its sum); an f32 image out."""
    return _combine_cost(x, 4, 4)


kernel("xImageSum", ref=ref.ximage_sum, cost=ximage_sum_cost)(ximage_sum)
kernel("rss", ref=ref.rss, cost=rss_cost)(rss)
