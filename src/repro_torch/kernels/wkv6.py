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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.registry import Cost, count_launch, kernel
from . import _build, ref
from .common import check_cuda, check_in_place, check_out, launch, nbytes

DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's template instances, the configs' head sizes (SMOKE, full
#: width): a thread keeps 2 D / 8 state floats in registers
HEAD_DIMS = (8, 64)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: Optional[torch.Tensor] = None, *,
         state_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, T, H, D), one dtype; w: (B, T, H, D) f32; u: (H, D) f32;
    state: (B, H, D, D) f32 or None (zeros).  Returns (out (B, T, H, D) in
    r's dtype, final state (B, H, D, D) f32).  The final state is written
    into ``state_out`` when given, which may be ``state`` itself (the
    decode cache, updated in place)."""
    if r.ndim != 4 or any(tuple(t.shape) != tuple(r.shape) for t in (k, v, w)):
        raise ValueError(f"need r, k, v, w of one (B, T, H, D) shape; got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    b, t, h, d = r.shape
    if tuple(u.shape) != (h, d):
        raise ValueError(f"u {tuple(u.shape)}, expected {(h, d)}")
    sshape = (b, h, d, d)
    if state is not None and tuple(state.shape) != sshape:
        raise ValueError(f"state {tuple(state.shape)}, expected {sshape}")
    if r.device.type == "cpu":
        out, final = ref.wkv6(r, k, v, w, u, state)
        return out, final if state_out is None else state_out.copy_(final)
    check_cuda("r", r, DTYPES)
    for name, x in (("k", k), ("v", v)):
        check_cuda(name, x, (r.dtype,), device=r.device)
    check_cuda("w", w, (torch.float32,), device=r.device)
    check_cuda("u", u, (torch.float32,), device=r.device)
    if state is not None:
        check_cuda("state", state, (torch.float32,), device=r.device)
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d}: the kernel keeps its state slice in registers and "
                         f"is built for head sizes {HEAD_DIMS}")
    if b * h > 2**31 - 1:
        raise ValueError(f"{b} batches x {h} heads exceed the kernel's grid")
    if state_out is None:
        state_out = torch.empty(sshape, dtype=torch.float32, device=r.device)
    else:
        check_out(state_out, sshape, torch.float32, r.device)
        if state is not None:
            check_in_place(state_out, state)
    out = torch.empty_like(r)
    err = launch(_build.library().rt_wkv6, r, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                 w.data_ptr(), u.data_ptr(), None if state is None else state.data_ptr(),
                 state_out.data_ptr(), out.data_ptr(), b, t, h, d,
                 int(r.dtype == torch.bfloat16))
    _build.check(err, "wkv6")
    count_launch("wkv6")
    return out, state_out


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


kernel("wkv6", ref=ref.wkv6, cost=wkv6_cost)(wkv6)
