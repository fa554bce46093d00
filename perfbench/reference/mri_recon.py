"""Plain reference of the paper's reconstruction (arXiv:1807.11830, eq. 1):
M = sum over coils of conj(S_c) . IFFT2(Y_c), the orthonormal inverse FFT
over the two trailing axes.  Complex128 torch; it imports nothing of the
program.  ``rounding="bf16"`` is the lower-precision control: the k-space,
the maps and the image held as bfloat16 pairs, the arithmetic in float32.
"""
from __future__ import annotations

from typing import Optional

import torch


def _bf16(z: torch.Tensor) -> torch.Tensor:
    r = torch.view_as_real(z).to(torch.bfloat16).float()
    return torch.view_as_complex(r.contiguous())


def recon(kspace: torch.Tensor, maps: torch.Tensor, rounding: Optional[str] = None
          ) -> torch.Tensor:
    """kspace (F, C, H, W), maps (C, H, W) -> image (F, H, W)."""
    if rounding is None:
        k, s = kspace.to(torch.complex128), maps.to(torch.complex128)
        return (torch.fft.ifft2(k, norm="ortho") * s.conj()).sum(1)
    if rounding != "bf16":
        raise ValueError(f"unknown rounding {rounding!r}")
    k, s = _bf16(kspace.to(torch.complex64)), _bf16(maps.to(torch.complex64))
    return _bf16((torch.fft.ifft2(k, norm="ortho") * s.conj()).sum(1))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    want = want.to(torch.complex128)
    return float((got.to(torch.complex128) - want).abs().max() / want.abs().max())
