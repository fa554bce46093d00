"""RMS norm over the last axis (LM hot path): ``x * rsqrt(mean(x²) + eps)
* w`` in f32, output in x's dtype, and its gradient.

On CUDA tensors it is the hand-written one-pass ``rmsnorm_kernel`` family
(``csrc/lm_kernels.cu``: each row read once into registers in 16-byte
vectors, the thread count per row chosen by its width), replacing the
Pallas kernel of ``repro/kernels/rmsnorm.py``; on CPU tensors it is the
plain version in :mod:`.ref`.  The wrapper runs at every norm of every
layer (161 calls a qwen3-14b decode step), so its host path is kept short:
see :func:`.common.launch`.

When autograd needs a gradient of a CUDA call (a training forward), the
call goes through :class:`RMSNormFn`, whose backward is the hand-written
``rmsnorm_bwd_kernel`` (dx, and per-block partials of dw) followed by
``rmsnorm_dw_reduce_kernel`` (the partials summed in block order): no
float atomics, so the gradient is the same on every run.  The JAX package
trains through plain ``jnp``, so the gradient has no Pallas kernel to
replace; its plain version is autograd through :func:`.ref.rmsnorm`.
"""
from __future__ import annotations

import torch

from repro_torch.core.registry import Cost, count_launch, kernel
from . import _build, ref
from .common import check_cuda, counting, launch, nbytes, traced

DTYPES = (torch.float32, torch.bfloat16)
#: widest row the backward kernel takes (256 threads x 32 columns)
BWD_MAX_WIDTH = 8192
#: row runs of the backward (dw partials): 2 blocks an SM of an H100 at most
BWD_BLOCKS = 264


def _forward(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    if x.is_meta or counting():
        return traced("rmsnorm", lambda: _forward(x, weight, eps), lambda: torch.empty_like(x),
                      x, weight, eps)
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


class RMSNormFn(torch.autograd.Function):
    """:func:`rmsnorm` on CUDA tensors with the hand-written backward (on
    ``meta`` tensors, and under a counting mode on CPU ones, with the
    entries' costs)."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _forward(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, weight, dy.contiguous(), ctx.eps)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); weight: (D,).  Matches :func:`ref.rmsnorm`."""
    if x.ndim < 1 or weight.shape != x.shape[-1:]:
        raise ValueError(f"weight {tuple(weight.shape)} does not match x {tuple(x.shape)}")
    if x.is_cpu and not counting():
        return ref.rmsnorm(x, weight, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return RMSNormFn.apply(x, weight, eps)
    return _forward(x, weight, eps)


def rmsnorm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of :func:`rmsnorm` at ``x``, ``weight`` for the output
    gradient ``dy``: dx in x's dtype, dw in the weight's.  Matches
    :func:`ref.rmsnorm_bwd`."""
    if tuple(dy.shape) != tuple(x.shape) or weight.shape != x.shape[-1:]:
        raise ValueError(f"x {tuple(x.shape)}, weight {tuple(weight.shape)} and dy "
                         f"{tuple(dy.shape)} do not match")
    if x.is_meta or counting():
        return traced("rmsnorm_bwd", lambda: rmsnorm_bwd(x, weight, dy, eps),
                      lambda: (torch.empty_like(x), torch.empty_like(weight)), x, weight, dy, eps)
    if x.is_cpu:
        return ref.rmsnorm_bwd(x, weight, dy, eps)
    check_cuda("x", x, DTYPES, aligned=False)
    check_cuda("weight", weight, DTYPES, device=x.device, aligned=False)
    check_cuda("dy", dy, (x.dtype,), device=x.device, aligned=False)
    d = x.shape[-1]
    if d > BWD_MAX_WIDTH:
        raise ValueError(f"rows {d} wide: the backward kernel takes at most {BWD_MAX_WIDTH}")
    rows = x.numel() // d if d else 0
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(weight)
    blocks = min(BWD_BLOCKS, rows)
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    dw = torch.empty_like(weight)
    err = launch(_build.library().rt_rmsnorm_bwd, x, x.data_ptr(), weight.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), part.data_ptr(), dw.data_ptr(), rows, d, blocks,
                 x.dtype == torch.bfloat16, weight.dtype == torch.bfloat16, eps)
    _build.check(err, "rmsnorm_bwd")
    count_launch("rmsnorm_bwd")
    return dx, dw


def rmsnorm_cost(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> Cost:
    """Read x and the weight, write x's shape; 4 flops an element (square,
    sum, scale, weight), held to the bf16 tensor rate for bf16 rows."""
    peak = "bf16_tensor" if x.dtype == torch.bfloat16 else "fp32"
    return Cost(4 * x.numel(), 2 * nbytes(x) + nbytes(weight), peak)


def rmsnorm_bwd_cost(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-6) -> Cost:
    """Read x, dy and the weight, write dx and dw; 9 flops an element (the
    two row sums, dx, and dw's product and sum), the same peaks as the
    forward."""
    peak = "bf16_tensor" if x.dtype == torch.bfloat16 else "fp32"
    return Cost(9 * x.numel(), 3 * nbytes(x) + 2 * nbytes(weight), peak)


kernel("rmsnorm", ref=ref.rmsnorm, cost=rmsnorm_cost)(rmsnorm)
kernel("rmsnorm_bwd", ref=ref.rmsnorm_bwd, cost=rmsnorm_bwd_cost)(rmsnorm_bwd)
