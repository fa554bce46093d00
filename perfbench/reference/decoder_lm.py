"""Plain reference of a dense decoder LM (h2o-danube-1.8b): the forward
pass, the loss, its gradient and AdamW, in float32 torch with TF32 off.

Written from the configuration file and the published architecture alone
(pre-norm RMSNorm, rotary positions by rotate-half, grouped-query causal
attention within a sliding window, a SwiGLU MLP, untied embedding and
unembedding); it imports nothing of the program.  ``rounding`` makes the
lower-precision control: every matrix product's operands (and, in the
backward, its incoming gradient) are rounded to that type first.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def strict_fp32() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rounded(x: torch.Tensor, rounding: Optional[str]) -> torch.Tensor:
    """``x`` (f32) as the ``rounding`` type would hold it, back in f32:
    ``fp8`` (e4m3, one scale a tensor from its largest magnitude)."""
    if rounding is None:
        return x
    if rounding == "fp8":
        s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s
    raise ValueError(f"unknown rounding {rounding!r}")


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rounding):
        ctx.rounding = rounding
        ctx.save_for_backward(a, b)
        return rounded(a, rounding) @ rounded(b, rounding)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ctx.rounding
        qa, qb, qg = rounded(a, r), rounded(b, r), rounded(g, r)
        da = qg @ qb.transpose(-1, -2)
        if b.dim() == 2:
            db = qa.reshape(-1, a.shape[-1]).T @ qg.reshape(-1, g.shape[-1])
        else:
            db = qa.transpose(-1, -2) @ qg
        return da, db, None


def mm(a: torch.Tensor, b: torch.Tensor, rounding: Optional[str]) -> torch.Tensor:
    if rounding is None:
        return a @ b
    return _RoundedMatmul.apply(a, b, rounding)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, H, S, D), positions (S,): rotate-half rotary embedding."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions.float()[:, None] * freqs                       # (S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: Optional[int], rounding, rows: int = 512) -> torch.Tensor:
    """Causal grouped-query attention of (B, H, S, D) queries over (B, Hkv,
    S, D) keys and values, query i attending to keys (i - window, i]; in
    blocks of ``rows`` queries so that the scores stay small."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    kpos = torch.arange(s, device=q.device)
    outs = []
    for i in range(0, s, rows):
        qi = q[:, :, i:i + rows] * (d ** -0.5)
        qpos = kpos[i:i + rows, None]
        visible = kpos[None, :] <= qpos
        if window is not None:
            visible &= kpos[None, :] > qpos - window
        scores = mm(qi, k.transpose(-1, -2), rounding)
        scores = scores.masked_fill(~visible, float("-inf"))
        outs.append(mm(torch.softmax(scores, dim=-1), v, rounding))
    return torch.cat(outs, dim=2)


def layer(arch: Dict, x: torch.Tensor, ln_attn, w_q, w_k, w_v, w_o, ln_mlp, w_gate, w_up,
          w_down, rounding: Optional[str]) -> torch.Tensor:
    b, s, _ = x.shape
    h, kv, dh = arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
    pos = torch.arange(s, device=x.device)
    y = rmsnorm(x, ln_attn)
    q = mm(y, w_q, rounding).view(b, s, h, dh).transpose(1, 2)
    k = mm(y, w_k, rounding).view(b, s, kv, dh).transpose(1, 2)
    v = mm(y, w_v, rounding).view(b, s, kv, dh).transpose(1, 2)
    q, k = rope(q, pos, arch["rope_theta"]), rope(k, pos, arch["rope_theta"])
    o = attention(q, k, v, arch.get("window"), rounding)
    x = x + mm(o.transpose(1, 2).reshape(b, s, h * dh), w_o, rounding)
    y = rmsnorm(x, ln_mlp)
    return x + mm(F.silu(mm(y, w_gate, rounding)) * mm(y, w_up, rounding), w_down, rounding)


LAYER_LEAVES = ("['layers']['ln_attn']['scale']", "['layers']['attn']['w_q']",
                "['layers']['attn']['w_k']", "['layers']['attn']['w_v']",
                "['layers']['attn']['w_o']", "['layers']['ln_mlp']['scale']",
                "['layers']['mlp']['w_gate']", "['layers']['mlp']['w_up']",
                "['layers']['mlp']['w_down']")


def logits(arch: Dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
           rounding: Optional[str] = None, remat: bool = False) -> torch.Tensor:
    """(B, S, V) f32 logits of (B, S) tokens; ``params`` by key path, f32."""
    x = F.embedding(tokens.long(), params["['embed']['embedding']"])
    for i in range(arch["n_layers"]):
        leaves = [params[n][i] for n in LAYER_LEAVES]
        if remat:
            x = checkpoint(layer, arch, x, *leaves, rounding, use_reentrant=False)
        else:
            x = layer(arch, x, *leaves, rounding)
    x = rmsnorm(x, params["['final_norm']['scale']"])
    return mm(x, params["['embed']['unembed']"], rounding)


def loss(arch: Dict, params, tokens, labels, rounding=None) -> torch.Tensor:
    lg = logits(arch, params, tokens, rounding, remat=True)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1).long())


def train(arch: Dict, init: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]],
          opt: Dict, rounding: Optional[str] = None) -> Dict:
    """AdamW steps from ``init`` (the weights by key path) on ``batches``:
    each step's loss, each leaf's norm of the first step's clipped gradient
    (what the optimizer receives), and each leaf's norm of its change over
    all the steps.  Leaves are updated one at a time, as the program does."""
    strict_fp32()
    names = list(init)
    params = {n: init[n].float().clone().requires_grad_(True) for n in names}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    b1, b2, eps, wd, clip, lr = (opt[k] for k in ("b1", "b2", "eps", "weight_decay",
                                                  "clip_norm", "lr"))
    out = {"losses": [], "grad_norms": {}, "grad_norm_total": []}
    for step, batch in enumerate(batches, start=1):
        total = loss(arch, params, batch["tokens"], batch["labels"], rounding)
        grads = torch.autograd.grad(total, [params[n] for n in names])
        out["losses"].append(float(total.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = min(1.0, clip / max(float(gnorm), 1e-9)) if clip is not None else 1.0
            out["grad_norm_total"].append(float(gnorm))
            c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for n, g in zip(names, grads):
                g = g * scale
                if step == 1:
                    out["grad_norms"][n] = float(torch.linalg.vector_norm(g))
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (m[n] / c1) / (torch.sqrt(v[n] / c2) + eps)
                params[n].sub_(lr * (delta + wd * params[n]))
        del grads
    with torch.no_grad():
        out["change_norms"] = {n: float(torch.linalg.vector_norm(params[n] - init[n].float()))
                               for n in names}
    return out


@torch.no_grad()
def served_gaps(arch: Dict, params: Dict[str, torch.Tensor], tokens: List[int], prompt_len: int,
                rounding: Optional[str] = None) -> Dict[str, float]:
    """One request of prompt + served tokens, through one f32 forward
    pass: ``served``, the widest gap by which a served token's logit lies
    below the reference's best at its position; with ``rounding``, also
    ``control``, the widest such gap of the token that the rounded forward
    puts first."""
    strict_fp32()
    device = params["['embed']['embedding']"].device
    ids = torch.tensor(tokens, device=device)[None]
    ref = logits(arch, params, ids)[0]
    pos = torch.arange(prompt_len - 1, len(tokens) - 1, device=device)
    best = ref[pos].amax(-1)
    out = {"served": float((best - ref[pos, ids[0, pos + 1]]).max())}
    if rounding is not None:
        low = logits(arch, params, ids, rounding)[0]
        first = low[pos].argmax(-1)
        out["control"] = float((best - ref[pos, first]).max())
    return out


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             skip: Optional[set] = None) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    that leaf's reference norm and the median leaf's."""
    keys = [k for k in ref if not skip or k not in skip]
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def still_leaves(grad_norms: Dict[str, float]) -> set:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: round-off alone moves them under Adam."""
    med = sorted(grad_norms.values())[len(grad_norms) // 2]
    return {k for k, g in grad_norms.items() if g < 1e-3 * med}


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)
