"""Complex element-wise product (paper §IV-A, complexElementProd.cl).

``out[f, ...] = a[f, ...] * conj?(b[...])`` with ``b`` broadcast over the
leading (frame) axis of ``a``, or of ``a``'s own shape.  For CUDA tensors
this launches ``cprod_kernel`` (``csrc/mri_kernels.cu``); for CPU tensors
it runs the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core.registry import count_launch, kernel
from . import _build, ref
from .common import check_complex64, check_in_place, check_out, launch


def complex_elementprod(a: torch.Tensor, b: torch.Tensor,
                        conjugate_b: bool = False,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """a: (F, *S) complex; b: (*S) or (F, *S) complex; returns a * conj?(b).
    ``out`` may be ``a`` itself (in place on the arena)."""
    broadcast = b.ndim == a.ndim - 1
    if tuple(b.shape) != (tuple(a.shape[1:]) if broadcast else tuple(a.shape)):
        raise ValueError(f"bad shapes {tuple(a.shape)} vs {tuple(b.shape)}")
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
    frames = a.shape[0] if broadcast else 1
    err = launch(_build.library().rt_cprod, a, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 frames, b.numel(), int(bool(conjugate_b)))
    _build.check(err, "complex_elementprod")
    count_launch("complexElementProd")
    return out


kernel("complexElementProd", ref=ref.complex_elementprod)(complex_elementprod)
