"""Plain PyTorch versions of the kernels of the MRI path.

Each is the same function as a hand-written kernel beside it, in plain
tensor code.  A wrapper runs it for CPU tensors; the tests compare it with
the JAX package's Pallas kernels; ``chip_smoke.py`` compares each CUDA
kernel with it on the card.  Mirrors ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch

from .common import mag2


def complex_elementprod(a: torch.Tensor, b: torch.Tensor,
                        conjugate_b: bool = False) -> torch.Tensor:
    """Elementwise complex product, optionally conjugating ``b``
    (paper §IV-A: multiply x-images by conj(sensitivity maps))."""
    if conjugate_b:
        b = b.conj()
    return a * b


def ximage_sum(x: torch.Tensor, axis: int = -3) -> torch.Tensor:
    """Sum of per-coil x-images over the coil axis (paper §IV-A step 2)."""
    return x.sum(dim=axis)


def rss(x: torch.Tensor, axis: int = -3) -> torch.Tensor:
    """Root-sum-of-squares coil combination (paper §IV-B)."""
    return torch.sqrt(mag2(x).sum(dim=axis))


def mri_fused_epilogue(x: torch.Tensor, smaps: torch.Tensor,
                       combine: str = "sum") -> torch.Tensor:
    """Multiply the per-coil x-images by conj(smaps) and reduce the coil
    axis.  ``combine``: "sum" (eq. 1) or "rss" (Table I/II)."""
    prod = complex_elementprod(x, smaps, conjugate_b=True)
    if combine == "rss":
        return rss(prod)
    return ximage_sum(prod)


def mri_fused_recon(k: torch.Tensor, smaps: torch.Tensor, combine: str = "sum",
                    norm: str = "ortho") -> torch.Tensor:
    """Whole SimpleMRIRecon chain: IFFT2 -> conj(smaps) product -> combine."""
    x = torch.fft.ifft2(k, norm=norm)
    return mri_fused_epilogue(x, smaps, combine)
