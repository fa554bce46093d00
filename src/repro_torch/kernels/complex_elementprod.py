"""Complex element-wise product (paper §IV-A, complexElementProd.cl).

``out[f, ...] = a[f, ...] * conj?(b[...])`` with ``b`` broadcast over the
leading axes of ``a``, or of ``a``'s own shape; or, for a batch of slices
``a`` (B, F, C, H, W), with one map set ``b`` (B, C, H, W) per slice (what
a ``vmap`` over the JAX kernel computes).  For CUDA tensors this launches
``cprod_kernel`` (``csrc/mri_kernels.cu``); for CPU tensors it runs the
plain version in :mod:`.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core.registry import Cost, count_launch, kernel
from . import _build, ref
from .common import (check_complex64, check_in_place, check_out, counting, launch, nbytes,
                     out_or_empty, traced)


def map_sets(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int]:
    """(frames, elements of one map set, frames per map set) of ``a * b``:
    ``b`` of ``a``'s shape is one set of ``a.numel()`` elements; ``b``
    (B, *S) against ``a`` (B, F, *S) of 5 axes is B sets, one per leading
    item (this reading wins when ``b`` is also ``a``'s trailing shape, F =
    B); ``b`` of ``a``'s trailing shape is one set broadcast over all of
    ``a``'s leading axes."""
    if tuple(b.shape) == tuple(a.shape):
        return 1, b.numel(), 1
    if a.ndim == 5 and b.ndim == 4 and tuple(b.shape) == (a.shape[0],) + tuple(a.shape[2:]):
        return a.shape[0] * a.shape[1], b.numel() // max(b.shape[0], 1), max(a.shape[1], 1)
    if 0 < b.ndim < a.ndim and tuple(b.shape) == tuple(a.shape[a.ndim - b.ndim:]):
        frames = a.numel() // max(b.numel(), 1)
        return frames, b.numel(), max(frames, 1)
    raise ValueError(f"bad shapes {tuple(a.shape)} vs {tuple(b.shape)}")


def complex_elementprod(a: torch.Tensor, b: torch.Tensor,
                        conjugate_b: bool = False,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """a: (..., *S) complex; b: (*S), a's shape, or (B, C, H, W) against a
    (B, F, C, H, W) (:func:`map_sets`); returns a * conj?(b).  ``out`` may
    be ``a`` itself (in place on the arena)."""
    frames, m, fpm = map_sets(a, b)
    if a.is_meta or counting():
        return traced("complexElementProd", lambda: complex_elementprod(a, b, conjugate_b, out),
                      lambda: out_or_empty(out, a.shape, a.dtype, a.device), a, b, conjugate_b,
                      out)
    if a.device.type == "cpu":
        res = ref.complex_elementprod(a, b, conjugate_b)
        return res if out is None else out.copy_(res)
    check_complex64("a", a)
    check_complex64("b", b, device=a.device)
    if out is None:
        out = torch.empty_like(a)
    else:
        check_out(out, a.shape, torch.complex64, a.device)
        check_in_place(out, a)
    err = launch(_build.library().rt_cprod, a, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 frames, m, fpm, int(bool(conjugate_b)))
    _build.check(err, "complex_elementprod")
    count_launch("complexElementProd")
    return out


def complex_elementprod_cost(a: torch.Tensor, b: torch.Tensor, conjugate_b: bool = False,
                             out=None) -> Cost:
    """Read a and b, write a's shape; 6 flops a complex product."""
    return Cost(6 * a.numel(), 2 * nbytes(a) + nbytes(b))


kernel("complexElementProd", ref=ref.complex_elementprod,
       cost=complex_elementprod_cost)(complex_elementprod)
