"""RWKV6 (Finch) WKV recurrence (RWKV6 hot path, every layer of a prefill
and of a decode step):

    s_t = diag(exp(-exp(w_t))) s_{t-1} + k_t^T v_t
    o_t = r_t (s_{t-1} + diag(u) k_t^T v_t)

On CUDA tensors it is the hand-written ``wkv6_kernel``
(``csrc/rwkv_kernels.cu``), replacing the Pallas kernel of
``repro/kernels/wkv6.py``: the sequential f32 recurrence with each (batch,
head)'s state spread over a grid of (B * H, D / 32) blocks, a block owning
32 columns of the state and 8 lanes of a warp sharing a pair of columns
(D / 8 rows of both each, in registers, their partial outputs joined by one
reduce-scatter of shuffles per step); steps staged in shared memory a tile
at a time, outputs stored a tile at a time; the ``u`` term factored into
one scalar per step.  On CPU tensors it is the plain version
:func:`.ref.wkv6`.

When autograd needs a gradient of a CUDA call (the training forward), the
call goes through :class:`Wkv6Fn`: its forward is the same kernel, which
also writes the state entering every :data:`CHUNK`-th step (the output and
final state are the same bit for bit), and its backward is hand-written
and chunk-parallel: ``wkv6_bwd_contrib_kernel`` forms each chunk's term of
the state gradient's scan on the tensor cores, ``wkv6_bwd_scan_kernel``
runs that scan over the chunks (the one sequential part, elementwise) and
``wkv6_bwd_chunk_kernel`` gives every (batch, head, chunk) its dr, dk, dv
and dw from closed forms in the chunk's checkpoint and end gradient
(3xTF32 ``mma.sync`` products, the relative-decay terms on FMA, every
decay a product of per-step decays), ``wkv6_bwd_du_kernel`` adding du's
partials; no float atomics (the gradients are the same on every run).
The JAX package trains through its plain scan, so the gradient has no
Pallas kernel to replace; its plain version is autograd through
:func:`.ref.wkv6`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.registry import Cost, count_launch, kernel
from . import _build, ref
from .common import check_cuda, check_in_place, check_out, counting, launch, nbytes, traced

DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's template instances, the configs' head sizes (SMOKE, full
#: width): a thread keeps 2 D / 8 state floats in registers
HEAD_DIMS = (8, 64)


#: steps between the training forward's state checkpoints: the backward's
#: chunk (kWkvChunk)
CHUNK = 32


def _check_shapes(r, k, v, w, u, state) -> None:
    if r.ndim != 4 or any(tuple(t.shape) != tuple(r.shape) for t in (k, v, w)):
        raise ValueError(f"need r, k, v, w of one (B, T, H, D) shape; got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    b, t, h, d = r.shape
    if tuple(u.shape) != (h, d):
        raise ValueError(f"u {tuple(u.shape)}, expected {(h, d)}")
    if state is not None and tuple(state.shape) != (b, h, d, d):
        raise ValueError(f"state {tuple(state.shape)}, expected {(b, h, d, d)}")


def _check_cuda_inputs(r, k, v, w, u, state) -> None:
    check_cuda("r", r, DTYPES)
    for name, x in (("k", k), ("v", v)):
        check_cuda(name, x, (r.dtype,), device=r.device)
    check_cuda("w", w, (torch.float32,), device=r.device)
    check_cuda("u", u, (torch.float32,), device=r.device)
    if state is not None:
        check_cuda("state", state, (torch.float32,), device=r.device)
    b, _, h, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d}: the kernel keeps its state slice in registers and "
                         f"is built for head sizes {HEAD_DIMS}")
    if b * h > 2**31 - 1:
        raise ValueError(f"{b} batches x {h} heads exceed the kernel's grid")


def _forward(r, k, v, w, u, state, state_out, with_ckpt: bool):
    """The kernel: (out, final state, and with ``with_ckpt`` the state
    checkpoints (B, H, ceil(T / CHUNK), D, D) f32, else None).  On CPU
    tensors the plain version, with no checkpoints (its backward needs
    none)."""
    b, t, h, d = r.shape
    if r.is_meta or counting():
        def empty():
            final = state_out if state_out is not None else torch.empty(
                (b, h, d, d), dtype=torch.float32, device=r.device)
            ckpt = (torch.empty((b, h, -(-t // CHUNK), d, d), dtype=torch.float32,
                                device=r.device) if with_ckpt else None)
            return torch.empty_like(r), final, ckpt
        return traced("wkv6", lambda: _forward(r, k, v, w, u, state, state_out, with_ckpt), empty,
                      r, k, v, w, u, state, state_out=state_out)
    if r.is_cpu:
        out, final = ref.wkv6(r, k, v, w, u, state)
        return out, final if state_out is None else state_out.copy_(final), None
    _check_cuda_inputs(r, k, v, w, u, state)
    sshape = (b, h, d, d)
    if state_out is None:
        state_out = torch.empty(sshape, dtype=torch.float32, device=r.device)
    else:
        check_out(state_out, sshape, torch.float32, r.device)
        if state is not None:
            check_in_place(state_out, state)
    out = torch.empty_like(r)
    ckpt = (torch.empty((b, h, -(-t // CHUNK), d, d), dtype=torch.float32, device=r.device)
            if with_ckpt else None)
    err = launch(_build.library().rt_wkv6, r, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                 w.data_ptr(), u.data_ptr(), None if state is None else state.data_ptr(),
                 state_out.data_ptr(), out.data_ptr(), None if ckpt is None else ckpt.data_ptr(),
                 b, t, h, d, int(r.dtype == torch.bfloat16))
    _build.check(err, "wkv6")
    count_launch("wkv6")
    return out, state_out, ckpt


class Wkv6Fn(torch.autograd.Function):
    """:func:`wkv6` with the hand-written backward on CUDA tensors (the
    plain versions on CPU tensors, which count no launch; the entries'
    costs on ``meta`` tensors and under a counting mode).  It saves the
    inputs and, on the card, the forward's state checkpoints: never a
    state a step."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        out, final, ckpt = _forward(r, k, v, w, u, state, None, with_ckpt=True)
        ctx.save_for_backward(r, k, v, w, u, state, ckpt)
        ctx.set_materialize_grads(False)
        return out, final

    @staticmethod
    def backward(ctx, dout, dfinal):
        r, k, v, w, u, state, ckpt = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(r)
        return wkv6_bwd(r, k, v, w, u, state, dout.contiguous(),
                        None if dfinal is None else dfinal.contiguous(), ckpt=ckpt)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: Optional[torch.Tensor] = None, *,
         state_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, T, H, D), one dtype; w: (B, T, H, D) f32; u: (H, D) f32;
    state: (B, H, D, D) f32 or None (zeros).  Returns (out (B, T, H, D) in
    r's dtype, final state (B, H, D, D) f32).  The final state is written
    into ``state_out`` when given, which may be ``state`` itself (the
    decode cache, updated in place; not under autograd)."""
    _check_shapes(r, k, v, w, u, state)
    if r.device.type == "cpu" and not counting():
        out, final = ref.wkv6(r, k, v, w, u, state)
        return out, final if state_out is None else state_out.copy_(final)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (r, k, v, w, u, state)):
        if state_out is not None:
            raise ValueError("state_out: the training forward does not write a state in place")
        return Wkv6Fn.apply(r, k, v, w, u, state)
    return _forward(r, k, v, w, u, state, state_out, with_ckpt=False)[:2]


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: Optional[torch.Tensor], dout: torch.Tensor,
             dstate: Optional[torch.Tensor] = None, *, ckpt: Optional[torch.Tensor] = None):
    """(dr, dk, dv, dw, du, dstate_in) of :func:`wkv6` for the output
    gradient ``dout`` (r's shape and dtype) and the final state's
    ``dstate`` (None: zeros): dr, dk, dv in r's dtype, dw, du and the
    initial state's gradient f32 (None without a ``state``).  ``ckpt``:
    the training forward's state checkpoints (what :class:`Wkv6Fn` saves);
    without them the forward kernel runs first to write them (one more
    ``wkv6`` launch).  Scratch: the state gradient at each chunk's end (B,
    H, ceil(T / CHUNK), D, D) f32, the chunks' whole decays and du's
    per-(batch, chunk) partials.  Matches :func:`ref.wkv6_bwd`, which needs
    no checkpoints."""
    _check_shapes(r, k, v, w, u, state)
    b, t, h, d = r.shape
    if tuple(dout.shape) != tuple(r.shape):
        raise ValueError(f"dout {tuple(dout.shape)}, expected r's {tuple(r.shape)}")
    if dstate is not None and tuple(dstate.shape) != (b, h, d, d):
        raise ValueError(f"dstate {tuple(dstate.shape)}, expected {(b, h, d, d)}")
    if r.is_meta or counting():
        return traced("wkv6_bwd", lambda: wkv6_bwd(r, k, v, w, u, state, dout, dstate, ckpt=ckpt),
                      lambda: (torch.empty_like(r), torch.empty_like(r), torch.empty_like(r),
                               torch.empty_like(w), torch.empty_like(u),
                               None if state is None else torch.empty_like(state)),
                      r, k, v, w, u, state, dout, dstate, ckpt=ckpt)
    if r.is_cpu:
        return ref.wkv6_bwd(r, k, v, w, u, state, dout, dstate)
    _check_cuda_inputs(r, k, v, w, u, state)
    check_cuda("dout", dout, (r.dtype,), device=r.device)
    if dstate is not None:
        check_cuda("dstate", dstate, (torch.float32,), device=r.device)
    if ckpt is None:
        ckpt = _forward(r, k, v, w, u, state, None, with_ckpt=True)[2]
    check_out(ckpt, (b, h, -(-t // CHUNK), d, d), torch.float32, r.device)
    dr, dk, dv = torch.empty_like(r), torch.empty_like(r), torch.empty_like(r)
    dw = torch.empty_like(w)
    du = torch.empty_like(u)
    ds = None if state is None else torch.empty_like(state)
    if t == 0 or b * h == 0:     # no step: the state's gradient passes through
        for g in (dr, dk, dv, dw, du):
            g.zero_()
        if ds is not None:
            ds.copy_(dstate if dstate is not None else torch.zeros_like(ds))
        return dr, dk, dv, dw, du, ds
    nc = -(-t // CHUNK)
    gend = torch.empty((b, h, nc, d, d), dtype=torch.float32, device=r.device)
    tot = torch.empty((b, h, nc, d), dtype=torch.float32, device=r.device)
    du_part = torch.empty((b, nc, h, d), dtype=torch.float32, device=r.device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = launch(_build.library().rt_wkv6_bwd, r, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                 w.data_ptr(), u.data_ptr(), ckpt.data_ptr(), dout.data_ptr(), ptr(dstate),
                 ptr(ds), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                 du.data_ptr(), gend.data_ptr(), tot.data_ptr(), du_part.data_ptr(), b, t, h, d,
                 int(r.dtype == torch.bfloat16))
    _build.check(err, "wkv6_bwd")
    count_launch("wkv6_bwd")
    return dr, dk, dv, dw, du, ds


def wkv6_cost(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, state: Optional[torch.Tensor] = None, *,
              state_out: Optional[torch.Tensor] = None) -> Cost:
    """Read r, k, v, w, u and the state, write the output and the final
    state; per step and head 5 D^2 flops (r s, the decayed state plus k v)
    and 5 D for the u term, held to the fp32 rate."""
    b, t, h, d = r.shape
    states = (2 if state is not None else 1) * b * h * d * d * 4
    return Cost((5 * d + 5) * d * b * t * h,
                nbytes(r) * 2 + nbytes(k) + nbytes(v) + nbytes(w) + nbytes(u) + states)


def wkv6_bwd_cost(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  u: torch.Tensor, state: Optional[torch.Tensor], dout: torch.Tensor,
                  dstate: Optional[torch.Tensor] = None, *, ckpt=None) -> Cost:
    """Read r, k, v, w, u, dout (and the state and its gradient when
    given), write dr, dk, dv (r's dtype), dw, du (and the initial state's
    gradient); per step and head 14 D^2 flops (the state recomputed, 3;
    dr, dk, dw and dv, 2 each; G's update, 3) and 18 D for the staged
    sums, the u terms and dw's factor, held to the fp32 rate."""
    b, t, h, d = r.shape
    states = (0 if state is None else 2) + (0 if dstate is None else 1)
    moved = (4 * nbytes(r) + nbytes(k) + nbytes(v) + 2 * nbytes(w) + nbytes(dout)
             + 2 * nbytes(u) + states * b * h * d * d * 4)
    return Cost((14 * d + 18) * d * b * t * h, moved)


kernel("wkv6", ref=ref.wkv6, cost=wkv6_cost)(wkv6)
kernel("wkv6_bwd", ref=ref.wkv6_bwd, cost=wkv6_bwd_cost)(wkv6_bwd)
