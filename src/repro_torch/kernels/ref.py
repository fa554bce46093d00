"""Plain PyTorch versions of the port's kernels.

Each is the same function as a hand-written kernel beside it, in plain
tensor code.  A wrapper runs it for CPU tensors; the tests compare it with
the JAX package's Pallas kernels; ``chip_smoke.py`` compares each CUDA
kernel with it on the card.  Mirrors ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch

from .common import mag2

#: query lengths at least this long (and divisible by ``ATTN_CHUNK``) take
#: the q-chunked path of :func:`attention`, bounding the logits buffer
ATTN_CHUNK_THRESHOLD = 4096
ATTN_CHUNK = 1024


def negate(x: torch.Tensor) -> torch.Tensor:
    """Paper listing 4: ``output[i] = 1.0 - input[i]`` (intensity
    inversion), in x's dtype."""
    return (1.0 - x).to(x.dtype)


def map_sets(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``b`` as it broadcasts against ``a``: a batch of map sets (B, C, H, W)
    against (B, F, C, H, W) gains the frame axis, one set per leading item
    (as a ``vmap`` over the JAX kernels pairs them)."""
    if a.ndim == 5 and b.ndim == 4 and tuple(b.shape) == (a.shape[0],) + tuple(a.shape[2:]):
        return b.unsqueeze(1)
    return b


def complex_elementprod(a: torch.Tensor, b: torch.Tensor,
                        conjugate_b: bool = False) -> torch.Tensor:
    """Elementwise complex product, optionally conjugating ``b``
    (paper §IV-A: multiply x-images by conj(sensitivity maps)); ``b``
    broadcast over ``a``'s leading axes, or one map set a slice
    (:func:`map_sets`)."""
    if conjugate_b:
        b = b.conj()
    return a * map_sets(a, b)


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
                    norm: str = "ortho", tables=None) -> torch.Tensor:
    """Whole SimpleMRIRecon chain: IFFT2 -> conj(smaps) product -> combine.
    ``tables`` (the kernel's IDFT tables) is taken and not needed, so the
    kernel chooser can call both with one set of arguments."""
    x = torch.fft.ifft2(k, norm=norm)
    return mri_fused_epilogue(x, smaps, combine)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS layer norm over the last axis in f32, output in x's dtype (LM
    hot path)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rmsnorm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of :func:`rmsnorm` for the output gradient ``dy``: autograd
    through it (dx in x's dtype, dw in the weight's)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        wg = weight.detach().requires_grad_(True)
        dx, dw = torch.autograd.grad(rmsnorm(xg, wg, eps), (xg, wg), dy)
    return dx, dw


def _attend_block(qf, kf, vf, q_off, causal, window, skv, logit_cap):
    """One q-block of attention.  qf: (B, H, Cq, D) pre-scaled f32."""
    cq = qf.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if logit_cap is not None:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    q_pos = q_off + torch.arange(cq, device=qf.device)[:, None]
    k_pos = torch.arange(skv, device=qf.device)[None, :]
    mask = torch.ones((cq, skv), dtype=torch.bool, device=qf.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask[None, None], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int | None = None, scale: float | None = None,
              logit_cap: float | None = None) -> torch.Tensor:
    """Multi-head attention with GQA, causal and sliding-window masks.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); Hq % Hkv == 0.  ``window``
    attends to keys in (i - window, i].  Query i sits at position
    i + Skv - Sq (aligned to the END of the keys), which covers prefill
    (Sq == Skv) and single-token decode (Sq == 1).  Long query sequences
    run in chunks of ``ATTN_CHUNK`` rows so the logits buffer stays
    (B, H, chunk, Skv)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    offset = skv - sq
    if sq < ATTN_CHUNK_THRESHOLD or sq % ATTN_CHUNK != 0:
        return _attend_block(qf, kf, vf, offset, causal, window, skv, logit_cap).to(q.dtype)
    outs = [_attend_block(qf[:, :, i:i + ATTN_CHUNK], kf, vf, offset + i, causal, window,
                          skv, logit_cap)
            for i in range(0, sq, ATTN_CHUNK)]
    return torch.cat(outs, dim=2).to(q.dtype)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out, dout: torch.Tensor,
                  lse=None, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None):
    """(dq, dk, dv) of :func:`attention` for the output gradient ``dout``:
    autograd through it.  ``out`` and ``lse`` (the kernel's saved forward
    output and log-sum-exp) are taken and not needed, so the kernel and
    this version take one set of arguments."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = attention(*leaves, causal=causal, window=window, scale=scale)
        return torch.autograd.grad(o, leaves, dout)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor | None = None):
    """RWKV6 (Finch) time-mix recurrence, a loop over t in f32.

    r, k, v, w: (B, T, H, D); u: (H, D); state: (B, H, D, D) or None.
    s_t = diag(exp(-exp(w_t))) s_{t-1} + k_t^T v_t
    o_t = r_t (s_{t-1} + diag(u) k_t^T v_t)
    Returns (out (B, T, H, D) in r's dtype, final state (B, H, D, D) f32).
    """
    b, t, h, d = r.shape
    s = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    rf, kf, vf = r.float(), k.float(), v.float()
    decay = torch.exp(-torch.exp(w.float()))
    uf = u.float()[None, :, :, None]                          # (1, H, D, 1)
    outs = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]      # (B, H, D, D)
        outs.append(torch.einsum("bhd,bhde->bhe", rf[:, i], s + uf * kv))
        s = s * decay[:, i, :, :, None] + kv
    out = torch.stack(outs, dim=1) if outs else torch.zeros_like(rf)
    return out.to(r.dtype), s


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor | None, dout: torch.Tensor,
             dstate: torch.Tensor | None = None, ckpt=None):
    """(dr, dk, dv, dw, du, dstate_in) of :func:`wkv6` for the output
    gradient ``dout`` and the final state's ``dstate`` (None: zeros):
    autograd through it; ``dstate_in`` is None without an input state.
    ``ckpt`` (the kernel's state checkpoints) is taken and not needed, so
    the kernel and this version take one set of arguments."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (r, k, v, w, u)]
        s0 = None if state is None else state.detach().requires_grad_(True)
        out, final = wkv6(*leaves, s0)
        outs, grads = [out], [dout]
        if dstate is not None:
            outs.append(final)
            grads.append(dstate)
        inputs = leaves + ([] if s0 is None else [s0])
        got = torch.autograd.grad(outs, inputs, grads, allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g for g, t in zip(got, inputs)]
    return (*got[:5], got[5] if s0 is not None else None)
