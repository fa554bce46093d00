"""RWKV6 "Finch", the ssm family: an attention-free LM with data-dependent
decay (rwkv6-3b).

Mirrors ``repro/models/rwkv6.py``.  Time-mix: token-shift ddlerp (a
low-rank, data-dependent interpolation of the five r/k/v/w/g streams), the
WKV6 recurrence (the ``wkv6`` kernel wrapper: the hand-written CUDA kernel
on CUDA tensors, the plain version on CPU tensors), per-head group norm,
gated output.  Channel-mix: a token-shifted squared-ReLU MLP.  The decode
state is O(1) per slot: two shift vectors and the (H, D, D) WKV state per
layer.

The serving entry points ``prefill`` and ``decode_step`` write the cache
they are given (views of the decode-state arena) in place and return it:
the kernel writes each layer's final WKV state straight over
``cache["wkv"][i]``, and the shift vectors are copied into
``cache["tm_shift"][i]`` / ``cache["cm_shift"][i]``.  The training entry
points ``hidden_states`` and ``loss_fn`` write nothing in place, so
autograd differentiates them (through the norm and WKV kernels'
hand-written backward passes on CUDA tensors).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import wkv6
from . import layers as L
from . import parallel as tp
from .layers import _spec as spec
from .common import (MODEL, SLOT_AXES, ArchConfig, Rules, alloc_tree, init_tree, remat_call, stacked,
                     tree_flatten, tree_map, unstacked)
from .parallel import ModelGroup

Params = Dict[str, Any]

TM_LORA = 32   # ddlerp low-rank dim
TD_LORA = 64   # decay low-rank dim


def _heads(cfg: ArchConfig) -> Tuple[int, int]:
    dh = cfg.rwkv_head_dim
    return cfg.d_model // dh, dh


def layer_specs(cfg: ArchConfig) -> Params:
    """One layer's parameters, as ``init_rwkv_layer`` of the JAX package
    lays them out (``u`` is float32, everything else ``param_dtype``)."""
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    nh, dh = _heads(cfg)
    vec = spec((d,), pd)
    tm = {name: vec for name in ("maa_x", "maa_w", "maa_k", "maa_v", "maa_r", "maa_g",
                                 "decay", "gn_scale", "gn_bias")}
    tm.update(tm_w1=spec((d, 5 * TM_LORA), pd), tm_w2=spec((5, TM_LORA, d), pd),
              td_w1=spec((d, TD_LORA), pd), td_w2=spec((TD_LORA, d), pd),
              u=spec((nh, dh), "float32"),
              **{w: spec((d, d), pd) for w in ("w_r", "w_k", "w_v", "w_g", "w_o")})
    cm = {"maa_k": vec, "maa_r": vec, "w_k": spec((d, f), pd), "w_v": spec((f, d), pd),
          "w_r": spec((d, d), pd)}
    return {"ln1": L.norm_specs(cfg), "ln2": L.norm_specs(cfg), "tm": tm, "cm": cm}


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token shift: x_{t-1}; position 0 gets ``last`` (B, D) or zeros."""
    prev = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, nh: int, dh: int,
                eps: float = 64e-5) -> torch.Tensor:
    """Per-head layer norm of (B, T, D), f32 out."""
    b, t, d = x.shape
    xg = x.reshape(b, t, nh, dh).float()
    mu = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, unbiased=False, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(b, t, d) * scale.float() + bias.float()


#: the order of the five ddlerp streams in :func:`_streams`' stack
STREAMS = ("w", "k", "v", "r", "g")


def _streams(p: Params, x: torch.Tensor, sx: torch.Tensor, tm_w1: torch.Tensor,
             tm_w2: torch.Tensor) -> torch.Tensor:
    """The ddlerp of the five streams (:data:`STREAMS`) stacked, (B, T, 5,
    D), from the LoRA weights given whole."""
    b, t, _ = x.shape
    xxx = x + sx * p["maa_x"]
    lora = torch.tanh(xxx @ tm_w1).reshape(b, t, 5, TM_LORA)
    mixes = torch.einsum("btfl,fld->btfd", lora, tm_w2)           # (B, T, 5, D)
    maa = torch.stack([p[f"maa_{n}"] for n in STREAMS])           # (5, D)
    return x[:, :, None] + sx[:, :, None] * (maa + mixes)


def _decay(p: Params, xw: torch.Tensor, td_w1: torch.Tensor, td_w2: torch.Tensor
           ) -> torch.Tensor:
    """The data-dependent decay (B, T, D) f32 of the w stream."""
    return p["decay"].float() + (torch.tanh(xw @ td_w1) @ td_w2).float()


def _heads_out(p: Params, xs: torch.Tensor, w: torch.Tensor, u, gn_scale, gn_bias,
               cfg: ArchConfig, wkv_state=None, state_out=None):
    """r, k, v and the gate of the stacked streams ``xs`` through ``p``'s
    projections (some heads' columns of ``w_r``, ``w_k``, ``w_v``,
    ``w_g``), the WKV recurrence on those heads, their group norm and gate:
    ((B, T, heads x D) in the activation dtype, the new WKV state)."""
    b, t = xs.shape[:2]
    dh = cfg.rwkv_head_dim
    xk, xv, xr, xg = xs.unbind(2)[1:]
    r = (xr @ p["w_r"]).reshape(b, t, -1, dh)
    k = (xk @ p["w_k"]).reshape(b, t, -1, dh)
    v = (xv @ p["w_v"]).reshape(b, t, -1, dh)
    g = F.silu((xg @ p["w_g"]).float())
    nh = r.shape[2]
    out, new_state = wkv6(r, k, v, w.reshape(b, t, nh, dh), u, wkv_state, state_out=state_out)
    out = _group_norm(out.reshape(b, t, nh * dh), gn_scale, gn_bias, nh, dh)
    return (out * g).to(cfg.adtype), new_state


def time_mix(p: Params, x: torch.Tensor, cfg: ArchConfig,
             shift_in: Optional[torch.Tensor] = None, wkv_state: Optional[torch.Tensor] = None,
             state_out: Optional[torch.Tensor] = None):
    """x: (B, T, D).  Returns (out, new shift (B, D), new WKV state); the
    state is written into ``state_out`` when given (which may be
    ``wkv_state``, the cache updated in place)."""
    sx = _shift(x, shift_in) - x
    xs = _streams(p, x, sx, p["tm_w1"], p["tm_w2"])
    w = _decay(p, xs[:, :, 0], p["td_w1"], p["td_w2"])
    out, new_state = _heads_out(p, xs, w, p["u"], p["gn_scale"], p["gn_bias"], cfg,
                                wkv_state, state_out)
    return out @ p["w_o"], x[:, -1, :], new_state


def time_mix_lanes(p: List[Params], x: List[torch.Tensor], cfg: ArchConfig,
                   group: ModelGroup) -> List[torch.Tensor]:
    """:func:`time_mix` of a training forward over a model group's lanes
    (``p`` each lane's pieces, ``x`` each lane's copy): the LoRA weights,
    whose column pieces cut inside its 32-wide groups, are gathered (2.3 MB
    a layer of rwkv6-3b in bf16; the (B, T, 5, D) mixes they make are 210
    MB at 4 x 2048), the five streams and the decay computed alike on
    every lane; each lane projects its heads (its columns of ``w_r``,
    ``w_k``, ``w_v``, ``w_g``, its rows of ``u``), runs the recurrence, the
    group norm and the gate on them and its rows of ``w_o``; the partial
    outputs are reduced.  The streams reach the projections through one
    ``copy`` of their stack: one backward sum a layer, so over distinct
    cards no lane's sum of stream gradients depends on which card's
    autograd thread finished first (four copies did)."""
    dh = cfg.rwkv_head_dim
    group.piece(cfg.d_model // dh, 0)          # the heads split over the lanes, or raise
    whole = {name: tp.gather(group, [pl[name] for pl in p], dim) for name, dim in (
        ("tm_w1", -1), ("tm_w2", -1), ("td_w1", -1), ("td_w2", 0))}
    xs = [_streams(pl, xl, _shift(xl) - xl, whole["tm_w1"][lane], whole["tm_w2"][lane])
          for lane, (pl, xl) in enumerate(zip(p, x))]
    w = tp.split(group, [_decay(pl, s[:, :, 0], whole["td_w1"][lane], whole["td_w2"][lane])
                         for lane, (pl, s) in enumerate(zip(p, xs))])
    gn_scale = tp.split(group, [pl["gn_scale"] for pl in p])
    gn_bias = tp.split(group, [pl["gn_bias"] for pl in p])
    return tp.reduce(group, [
        _heads_out(pl, s, wl, pl["u"], gs, gb, cfg)[0] @ pl["w_o"]
        for pl, s, wl, gs, gb in zip(p, tp.copy(group, xs), w, gn_scale, gn_bias)])


def channel_mix(p: Params, x: torch.Tensor, cfg: ArchConfig,
                shift_in: Optional[torch.Tensor] = None):
    """Returns (out, new shift (B, D))."""
    sx = _shift(x, shift_in) - x
    xk = x + sx * p["maa_k"]
    xr = x + sx * p["maa_r"]
    kv = torch.square(F.relu(xk @ p["w_k"])) @ p["w_v"]
    return torch.sigmoid((xr @ p["w_r"]).float()).to(cfg.adtype) * kv, x[:, -1, :]


def channel_mix_lanes(p: List[Params], x: List[torch.Tensor], cfg: ArchConfig,
                      group: ModelGroup) -> List[torch.Tensor]:
    """:func:`channel_mix` of a training forward over a model group: the
    squared-ReLU MLP as a Megatron MLP (``w_k`` by columns, ``w_v`` by
    rows, reduced); each lane's columns of the receptance ``sigmoid(xr @
    w_r)`` gathered (a (B, T, D) activation, where gathering ``w_r`` would
    move D x D and repeat its product on every lane) and applied alike.
    The two streams reach the projections through one ``copy`` of their
    stack (as in :func:`time_mix_lanes`)."""
    xs = tp.copy(group, [xl[:, :, None] + (_shift(xl) - xl)[:, :, None] * torch.stack(
        [pl["maa_k"], pl["maa_r"]]) for pl, xl in zip(p, x)])
    kv = tp.reduce(group, [torch.square(F.relu(s[:, :, 0] @ pl["w_k"])) @ pl["w_v"]
                           for pl, s in zip(p, xs)])
    r = tp.gather(group, [torch.sigmoid((s[:, :, 1] @ pl["w_r"]).float()).to(cfg.adtype)
                          for pl, s in zip(p, xs)])
    return [rl * kl for rl, kl in zip(r, kv)]


class RWKV6Model:
    """Functional model object: parameters and caches are nested dicts."""

    #: the kernel modules a forward launches (loaded by the LM processes)
    kernel_names = ("rmsnorm", "wkv6")

    def __init__(self, cfg: ArchConfig):
        if cfg.d_model % cfg.rwkv_head_dim:
            raise ValueError(f"{cfg.name}: d_model {cfg.d_model} is not a multiple of the "
                             f"head size {cfg.rwkv_head_dim}")
        self.cfg = cfg

    # ------------------------------------------------------------- params
    def param_specs(self) -> Params:
        """Shapes and dtypes of the parameter tree, nothing allocated."""
        cfg = self.cfg
        return {"embed": L.embed_specs(cfg), "ln0": L.norm_specs(cfg),
                "layers": stacked(layer_specs(cfg), cfg.n_layers),
                "final_norm": L.norm_specs(cfg)}

    def init_params(self, generator: torch.Generator, *, device=None,
                    out: Optional[Params] = None) -> Params:
        """Random parameters (:func:`~repro_torch.models.common.init_tree`);
        ``out``, e.g. the weights arena's views, is filled in place."""
        return init_tree(self.param_specs(), generator, device=device, out=out)

    # ------------------------------------------------------------- cache
    def cache_specs(self, batch: int, max_len: int) -> Params:
        """Two shift vectors and the WKV state per layer and slot; the size
        does not depend on ``max_len``."""
        cfg = self.cfg
        nh, dh = _heads(cfg)
        n, d = cfg.n_layers, cfg.d_model
        return {"tm_shift": spec((n, batch, d), cfg.dtype),
                "cm_shift": spec((n, batch, d), cfg.dtype),
                "wkv": spec((n, batch, nh, dh, dh), "float32")}

    def init_cache(self, batch: int, max_len: int, device=None) -> Params:
        return self.reset_cache(alloc_tree(self.cache_specs(batch, max_len), device))

    @staticmethod
    def reset_cache(cache: Params) -> Params:
        """Empty a cache in place: every shift and state zero."""
        for _, t in tree_flatten(cache):
            t.zero_()
        return cache

    # ------------------------------------------------------------- serve
    def _run_cached(self, params: Params, tokens: torch.Tensor,
                    cache: Params) -> Tuple[torch.Tensor, Params]:
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], tokens, cfg)
        x = L.apply_norm(params["ln0"], x, cfg)
        for i in range(cfg.n_layers):
            lp = tree_map(lambda a: a[i], params["layers"])
            tm_shift, cm_shift, wkv = (cache[k][i] for k in ("tm_shift", "cm_shift", "wkv"))
            h = L.apply_norm(lp["ln1"], x, cfg)
            out, shift, _ = time_mix(lp["tm"], h, cfg, tm_shift, wkv, state_out=wkv)
            tm_shift.copy_(shift)
            x = x + out
            h = L.apply_norm(lp["ln2"], x, cfg)
            out, shift = channel_mix(lp["cm"], h, cfg, cm_shift)
            cm_shift.copy_(shift)
            x = x + out
        x = L.apply_norm(params["final_norm"], x[:, -1:].contiguous(), cfg)
        return L.logits_from_hidden(params["embed"], x, cfg), cache

    def prefill(self, params: Params, tokens: torch.Tensor,
                cache: Params) -> Tuple[torch.Tensor, Params]:
        """Run a prompt (B, S) from the state in ``cache`` (zeros after
        :meth:`reset_cache`); returns (last-token logits (B, 1, V) f32,
        cache)."""
        return self._run_cached(params, tokens, cache)

    def decode_step(self, params: Params, token: torch.Tensor, pos,
                    cache: Params) -> Tuple[torch.Tensor, Params]:
        """token: (B, 1) int; ``pos`` is ignored (the recurrence has no
        positions).  Returns (logits (B, 1, V) f32, cache)."""
        del pos
        return self._run_cached(params, token, cache)

    # ------------------------------------------------------------- train
    def _layer_fwd(self, lp: Params, x: torch.Tensor,
                   group: Optional[ModelGroup] = None) -> torch.Tensor:
        cfg = self.cfg
        if group is not None:
            h = [L.apply_norm(n, xl, cfg) for n, xl in zip(tp.sub(lp, "ln1"), x)]
            x = [xl + o for xl, o in zip(x, time_mix_lanes(tp.sub(lp, "tm"), h, cfg, group))]
            h = [L.apply_norm(n, xl, cfg) for n, xl in zip(tp.sub(lp, "ln2"), x)]
            return [xl + o for xl, o in zip(x, channel_mix_lanes(tp.sub(lp, "cm"), h, cfg,
                                                                 group))]
        out, _, _ = time_mix(lp["tm"], L.apply_norm(lp["ln1"], x, cfg), cfg)
        x = x + out
        out, _ = channel_mix(lp["cm"], L.apply_norm(lp["ln2"], x, cfg), cfg)
        return x + out

    def hidden_states(self, params: Params, tokens: torch.Tensor,
                      group: Optional[ModelGroup] = None) -> torch.Tensor:
        """Full-sequence forward from zero states to the final hidden
        states (B, S, D).  With ``cfg.remat`` and autograd on, each layer
        runs under non-reentrant ``torch.utils.checkpoint``, as the
        reference wraps its scan body in ``jax.checkpoint``; ``ln0`` and the
        final norm stay outside.  With ``group`` (``params`` a tree a lane,
        :mod:`~repro_torch.models.parallel`), a list of the lanes' copies:
        each lane runs its heads of every time mix and its columns of every
        channel mix (:func:`time_mix_lanes`, :func:`channel_mix_lanes`), and
        remat holds a layer of every lane where the lanes share a device
        (:attr:`~repro_torch.models.parallel.ModelGroup.one_device`)."""
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        if group is not None:
            x = L.embed_tokens(tp.sub(params, "embed"), tokens, cfg, group)
            x = [L.apply_norm(n, xl, cfg) for n, xl in zip(tp.sub(params, "ln0"), x)]
            stacks = [unstacked(t, cfg.n_layers) for t in tp.sub(params, "layers")]
            for i in range(cfg.n_layers):
                x = remat_call(remat and group.one_device, self._layer_fwd,
                               [st[i] for st in stacks], x, group)
            return [L.apply_norm(n, xl, cfg) for n, xl in zip(tp.sub(params, "final_norm"), x)]
        x = L.embed_tokens(params["embed"], tokens, cfg)
        x = L.apply_norm(params["ln0"], x, cfg)
        for lp in unstacked(params["layers"], cfg.n_layers):
            x = remat_call(remat, self._layer_fwd, lp, x)
        return L.apply_norm(params["final_norm"], x, cfg)

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor],
                group: Optional[ModelGroup] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of a batch: tokens (B, S), labels (B, S)
        [, loss_mask (B, S)]; the mean token cross-entropy (with ``group``
        the vocabulary-parallel one, on the group's first device)."""
        embed = tp.sub(params, "embed") if group is not None else params["embed"]
        logits = L.logits_from_hidden(embed, self.hidden_states(params, batch["tokens"], group),
                                      self.cfg, group)
        loss = L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"), group)
        return loss, {"loss": loss}

    def cache_partition_rules(self) -> Rules:
        """Where the port's decode puts each cache leaf (the JAX package's
        ``cache_partition_rules`` names its sequence-over-``model``
        layout, which the port never runs): the slot axis over the
        batch's axes and then ``model``, each lane of a model group
        decoding its strip of slots (``DecodeStep``); where the slots do
        not divide, the dry run's fit leaves them replicated over
        ``model``."""
        return [(r"tm_shift|cm_shift|wkv", (None, SLOT_AXES))]

    def partition_rules(self) -> Rules:
        """The JAX package's rule table."""
        lay: Rules = [
            (r"tm.*tm_w1|tm.*td_w1", (None, MODEL)),
            (r"tm.*tm_w2", (None, None, MODEL)),
            (r"tm.*td_w2", (MODEL, None)),
            (r"tm.*w_r|tm.*w_k|tm.*w_v|tm.*w_g", (None, MODEL)),
            (r"tm.*w_o", (MODEL, None)),
            (r"tm.*'u'", (MODEL, None)),
            (r"cm.*w_k", (None, MODEL)),
            (r"cm.*w_v", (MODEL, None)),
            (r"cm.*w_r", (None, MODEL)),
        ]
        rules: Rules = [
            (r"embed.*embedding", (MODEL, None)),
            (r"embed.*unembed", (None, MODEL)),
        ]
        rules += [(rf"layers.*(?:{pat})", (None,) + spec) for pat, spec in lay]
        return rules
