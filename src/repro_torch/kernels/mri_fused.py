"""Fused MRI-reconstruction kernels: the chained per-stage processes
collapsed into one device pass.

* ``fused_epilogue``: multiply the per-coil x-images by conj(sensitivity
  maps) and reduce the coil axis (``"sum"``: eq. 1; ``"rss"``: §IV-B) in
  one kernel, so the (F, C, H, W) product never reaches device memory.
* ``fused_recon``: the whole chain including the IFFT.  Inside the gate
  (:func:`dft_fits`) the 2D IFFT is two DFT passes against precomputed
  inverse-DFT matrices inside ONE kernel (``dft_recon_kernel``); outside
  it, ``torch.fft.ifft2`` followed by the ``fused_epilogue`` kernel, as in
  the reference.

The gate comes from the card's limits, not the TPU's.  A block owns 16
output rows of one frame and keeps, in shared memory, the 16-row tile of
M_H and the 16-row intermediate T, each split into four TF32 planes, and the
(16, W) coil sums (:func:`recon_smem_bytes`: 104,448 bytes at 160x160,
165,888 at 256x256), whatever the coil count.  H, W <= 256: the 8
warps of a block own at most 4 eight-column tiles each, and beyond that
the O(N) DFT cost per output point loses to the radix FFT.  Frames ride on
``gridDim.y``.

Numerics: the two DFT passes run on the tensor cores as 3xTF32 (each
operand split into a TF32 pair, three products per real product, f32
accumulation), in another order than the radix FFT, so the result matches
``torch.fft.ifft2`` to ~1e-5 relative, not bitwise.
"""
from __future__ import annotations

import math

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.registry import Cost, count_launch, kernel
from . import _build, ref
from .common import (check_complex64, check_cuda, check_out, coil_grid, counting, launch,
                     nbytes, traced)

MAX_DFT_DIM = 256
SMEM_OPTIN_BYTES = 232448    # dynamic shared memory one Hopper block may opt into
MAX_GRID_Y = 65535           # frames ride on gridDim.y
RECON_ROWS = 16              # output rows a dft_recon_kernel block owns
_NORM_SCALE = {"ortho": np.sqrt, "backward": float, "forward": lambda n: 1.0}


def _check_pair(k: torch.Tensor, smaps: torch.Tensor, combine: str) -> int:
    """Check the shapes; return the frames per map set: all frames for maps
    of the coil grid (C, H, W), F for a batch of map sets (B, C, H, W)
    against k-space (B, F, C, H, W)."""
    if k.ndim < 3:
        raise ValueError("need (..., C, H, W) k-space / x-images")
    if combine not in ("sum", "rss"):
        raise ValueError(f"combine {combine!r}: expected 'sum' or 'rss'")
    grid = tuple(k.shape[-3:])
    if tuple(smaps.shape) == grid:
        return max(coil_grid(k)[0], 1)
    if k.ndim == 5 and tuple(smaps.shape) == (k.shape[0],) + grid:
        return max(k.shape[1], 1)
    raise ValueError(f"smaps shape {tuple(smaps.shape)} != coil grid {grid} "
                     f"(or (B,) + the coil grid against (B, F) + the coil grid)")


def _result(k: torch.Tensor, combine: str, out: Optional[torch.Tensor]) -> torch.Tensor:
    _, _, h, w = coil_grid(k)
    shape = tuple(k.shape[:-3]) + (h, w)
    dtype = torch.float32 if combine == "rss" else torch.complex64
    if out is None:
        return torch.empty(shape, dtype=dtype, device=k.device)
    check_out(out, shape, dtype, k.device)
    return out


# ---------------------------------------------------------------------------
# fused epilogue
# ---------------------------------------------------------------------------

def fused_epilogue(x: torch.Tensor, smaps: torch.Tensor, combine: str = "sum",
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., C, H, W) x-images * conj(smaps (C, H, W)) -> (..., H, W); or
    (B, F, C, H, W) against one map set a slice, smaps (B, C, H, W)."""
    fpm = _check_pair(x, smaps, combine)
    if x.is_meta or counting():
        return traced("mriFusedEpilogue", lambda: fused_epilogue(x, smaps, combine, out),
                      lambda: _result(x, combine, out), x, smaps, combine, out)
    if x.device.type == "cpu":
        res = ref.mri_fused_epilogue(x, smaps, combine)
        return res if out is None else out.copy_(res)
    check_complex64("x", x)
    check_complex64("smaps", smaps, device=x.device)
    f, c, h, w = coil_grid(x)
    out = _result(x, combine, out)
    err = launch(_build.library().rt_fused_epilogue, x, x.data_ptr(), smaps.data_ptr(),
                 out.data_ptr(), int(combine == "rss"), f, c, h * w, fpm)
    _build.check(err, "fused_epilogue")
    count_launch("mriFusedEpilogue")
    return out


# ---------------------------------------------------------------------------
# whole chain: in-kernel DFT IFFT inside the gate
# ---------------------------------------------------------------------------

def idft_matrix(n: int, norm: str) -> np.ndarray:
    """Inverse-DFT matrix M[a, b] = exp(2πi·ab/n) / scale, built in float64
    and cast to complex64 (re/im f32), as the reference's ``_idft_matrix``.
    Symmetric: M[a, b] == M[b, a]."""
    j = np.arange(n)
    m = np.exp(2j * np.pi * np.outer(j, j) / n) / _NORM_SCALE[norm](n)
    return m.astype(np.complex64)


def idft_fragment_table(n: int, norm: str) -> np.ndarray:
    """The (n, n) inverse-DFT matrix in the order the kernel's B operand
    loads it: (ceil(n / 8), 4, n, 4) f32, [k-group, t, column] -> (re of row
    8 k-group + t, re of row + t + 4, im of the two), zero past row n."""
    m = idft_matrix(n, norm)
    groups = -(-n // 8)
    padded = np.zeros((groups * 8, n, 2), np.float32)
    padded[:n, :, 0], padded[:n, :, 1] = m.real, m.imag
    # [group, half, t, column, part] -> [group, t, column, part, half]
    return np.ascontiguousarray(
        padded.reshape(groups, 2, 4, n, 2).transpose(0, 2, 3, 4, 1).reshape(groups, 4, n, 4))


def idft_tables(h: int, w: int, norm: str,
                device: torch.device | str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M_H, M_W) on ``device`` as the kernel reads them: M_H as the complex64
    matrix (:func:`idft_matrix`, staged once per block), M_W in fragment order
    (:func:`idft_fragment_table`, streamed per coil).  Built once, by
    ``init()``, per shape/norm."""
    return (torch.from_numpy(idft_matrix(h, norm)).to(device),
            torch.from_numpy(idft_fragment_table(w, norm)).to(device))


def recon_smem_bytes(h: int, w: int) -> int:
    """Dynamic shared memory of one ``dft_recon_kernel`` block (as the .cu's
    ``recon_smem_bytes``): the M_H row tile and T as A-operand tiles of 8
    row pairs (64 floats per 8-deep k-group, plus 16), and the (16, W)
    float2 coil sums (plus 16 floats a row)."""
    def groups(n: int) -> int:
        return -(-n // 8)
    pairs = RECON_ROWS // 2
    return (pairs * ((groups(h) * 64 + 16) + (groups(w) * 64 + 16))
            + RECON_ROWS * (groups(w) * 16 + 16)) * 4


def dft_fits(f: int, c: int, h: int, w: int) -> bool:
    """Whole-chain kernel gate: H and W within the 8 warps' column tiles
    (<= 256), the block's shared memory (independent of the coil count)
    within the opt-in limit, frames within gridDim.y."""
    return (h <= MAX_DFT_DIM and w <= MAX_DFT_DIM and f <= MAX_GRID_Y
            and recon_smem_bytes(h, w) <= SMEM_OPTIN_BYTES)


def fused_recon(k: torch.Tensor, smaps: torch.Tensor, combine: str = "sum",
                norm: str = "ortho",
                tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whole SimpleMRIRecon chain, (..., C, H, W) k-space -> (..., H, W),
    maps (C, H, W), or (B, C, H, W) against k-space (B, F, C, H, W).
    ``tables`` are the (M_H, M_W) of :func:`idft_tables` for this shape
    and ``norm``, made here when not given."""
    fpm = _check_pair(k, smaps, combine)
    if norm not in _NORM_SCALE:
        raise ValueError(f"norm {norm!r}")
    if k.is_meta or counting():
        return traced("mriFusedRecon", lambda: fused_recon(k, smaps, combine, norm, tables, out),
                      lambda: _result(k, combine, out), k, smaps, combine, norm, tables, out)
    if k.device.type == "cpu":
        res = ref.mri_fused_recon(k, smaps, combine, norm)
        return res if out is None else out.copy_(res)
    check_complex64("k", k)
    check_complex64("smaps", smaps, device=k.device)
    f, c, h, w = coil_grid(k)
    if not dft_fits(f, c, h, w):
        return fused_epilogue(torch.fft.ifft2(k, norm=norm), smaps, combine, out)
    mh, mw = tables if tables is not None else idft_tables(h, w, norm, k.device)
    check_complex64("M_H", mh, shape=(h, h), device=k.device)
    check_cuda("M_W", mw, (torch.float32,), device=k.device)   # 16-byte loads
    if tuple(mw.shape) != (-(-w // 8), 4, w, 4):
        raise ValueError(f"M_W: shape {tuple(mw.shape)}, expected {(-(-w // 8), 4, w, 4)} "
                         "as idft_tables makes it")
    out = _result(k, combine, out)
    err = launch(_build.library().rt_dft_recon, k, k.data_ptr(), smaps.data_ptr(),
                 mh.data_ptr(), mw.data_ptr(), out.data_ptr(), int(combine == "rss"), f, c, h, w,
                 fpm)
    _build.check(err, "fused_recon")
    count_launch("mriFusedRecon")
    return out


def _image_bytes(k: torch.Tensor, combine: str) -> int:
    """Bytes of the (..., H, W) result: complex64 summed, f32 by RSS."""
    return k.numel() // k.shape[-3] * (4 if combine == "rss" else 8)


def fused_epilogue_cost(x: torch.Tensor, smaps: torch.Tensor, combine: str = "sum",
                        out=None) -> Cost:
    """Read x and the maps, write the image; 8 flops an element (the
    conjugate product and the coil sum)."""
    return Cost(8 * x.numel(), nbytes(x) + nbytes(smaps) + _image_bytes(x, combine))


def fused_recon_cost(k: torch.Tensor, smaps: torch.Tensor, combine: str = "sum",
                     norm: str = "ortho", tables=None, out=None) -> Cost:
    """What the function needs, not what the DFT kernel does: an inverse
    FFT a (frame, coil) image, 5 N log2 N flops for its N = H W points,
    then the epilogue's 8 an element, at the fp32 rate; read k-space and
    the maps, write the image (the IDFT tables are the kernel's own
    constants, made from the shape)."""
    h, w = k.shape[-2:]
    n = k.numel()
    return Cost(5 * n * math.log2(h * w) + 8 * n,
                nbytes(k) + nbytes(smaps) + _image_bytes(k, combine))


kernel("mriFusedEpilogue", ref=ref.mri_fused_epilogue, cost=fused_epilogue_cost)(fused_epilogue)
kernel("mriFusedRecon", ref=ref.mri_fused_recon, cost=fused_recon_cost)(fused_recon)
