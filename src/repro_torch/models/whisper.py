"""Whisper-style encoder-decoder backbone (whisper-large-v3), the encdec
family.  The audio conv front end is stubbed, as in the JAX package: frames
come in as embeddings (B, T_enc, D).

Mirrors ``repro/models/whisper.py``.  The encoder adds sinusoidal
positions and runs bidirectional LayerNorm/GELU layers, its self-attention
through the flash-attention kernel with ``causal=False``
(:func:`~repro_torch.models.layers.attention_full`).  The decoder adds
learned positions and runs causal self-attention against the K/V cache and
cross-attention over the encoder states.  Cross-attention is the JAX
package's plain reference math (``kref.attention`` there, :func:`repro_torch.
kernels.ref.attention` here) at prefill and at decode: no Pallas kernel
covers it, so there is none to port.

As in :class:`~repro_torch.models.transformer.DecoderLM`, the stacked
``(L, ...)`` parameter layout is kept and the JAX ``lax.scan`` over layers
is a Python loop over layer views.  ``prefill_from_enc`` and
``decode_step`` write the cache they are given in place (views of the
decode-state arena): the self-attention K/V rows, and at prefill each
layer's cross K/V, cast to the activation dtype.  The training entry points
``encode``, ``decode_full`` and ``loss_fn`` write nothing in place, so
autograd differentiates them (through the attention kernel's hand-written
backward on CUDA tensors; cross-attention and the LayerNorms are plain).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import ref
from . import layers as L
from . import parallel as tp
from .common import (MODEL, SLOT_AXES, ArchConfig, Rules, alloc_tree, init_tree, remat_call, stacked,
                     tree_flatten, tree_map, unstacked)
from .layers import _spec as spec
from .parallel import ModelGroup

Params = Dict[str, Any]


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """(length, channels) f32 sinusoidal encoder positions: sines, then
    cosines, over geometric timescales 1 to 10000."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32,
                                                  device=device))
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def cross_attention_specs(cfg: ArchConfig) -> Params:
    d, h, dh, pd = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.param_dtype
    return {"w_q": spec((d, h * dh), pd), "w_k": spec((d, h * dh), pd),
            "w_v": spec((d, h * dh), pd), "w_o": spec((h * dh, d), pd)}


def cross_attention(p: Params, x: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, D); kc, vc: the encoder's K/V (B, H, T_enc, dh).  ``p``
    may hold some heads' columns of ``w_q`` and rows of ``w_o`` (a lane's,
    with their K/V): the result is then that lane's partial output."""
    b, s, _ = x.shape
    q = (x @ p["w_q"]).view(b, s, -1, cfg.head_dim).transpose(1, 2)
    o = ref.attention(q, kc, vc, causal=False)
    return o.transpose(1, 2).reshape(b, s, -1) @ p["w_o"]


def cross_kv(p: Params, enc: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder states (B, T, D) -> cross K, V (B, H, T, dh) (a lane's heads
    for its columns of ``w_k`` and ``w_v``)."""
    b, t, _ = enc.shape
    k = (enc @ p["w_k"]).view(b, t, -1, cfg.head_dim).transpose(1, 2)
    v = (enc @ p["w_v"]).view(b, t, -1, cfg.head_dim).transpose(1, 2)
    return k, v


def cross_attention_lanes(p: List[Params], x: List[torch.Tensor], enc: List[torch.Tensor],
                          cfg: ArchConfig, group: ModelGroup) -> List[torch.Tensor]:
    """Cross attention of a training forward over a model group: each lane
    projects its heads' queries from its copy of x and their K/V from its
    copy of the (replicated) encoder output, both through ``copy`` (so the
    encoder output's gradient is the lanes' sum, and over the decoder's
    layers the sum of every layer's), attends, and its rows of ``w_o``
    give a partial output; the partials are reduced."""
    group.piece(cfg.n_heads, 0)                # the heads split over the lanes, or raise
    return tp.reduce(group, [cross_attention(pl, xl, *cross_kv(pl, el, cfg), cfg)
                             for pl, xl, el in zip(p, tp.copy(group, x), tp.copy(group, enc))])


class WhisperModel:
    """Backbone of ``enc_layers`` encoder and ``dec_layers`` decoder blocks.
    Functional: parameters and caches are nested dicts of tensors."""

    #: the kernel modules a forward launches (loaded by the LM processes);
    #: LayerNorm is plain torch, as in the JAX package
    kernel_names = ("flash_attention",)

    def __init__(self, cfg: ArchConfig):
        if not (cfg.enc_layers and cfg.dec_layers):
            raise ValueError(f"{cfg.name}: an encoder-decoder needs enc_layers and dec_layers")
        self.cfg = cfg

    # ------------------------------------------------------------- params
    def param_specs(self, max_dec_positions: int = 32776) -> Params:
        """Shapes and dtypes of the parameter tree, nothing allocated;
        ``pos_dec`` holds ``max_dec_positions`` learned decoder positions."""
        cfg = self.cfg
        enc = {"ln_attn": L.norm_specs(cfg), "attn": L.attention_specs(cfg),
               "ln_mlp": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
        dec = {"ln_self": L.norm_specs(cfg), "self_attn": L.attention_specs(cfg),
               "ln_cross": L.norm_specs(cfg), "cross_attn": cross_attention_specs(cfg),
               "ln_mlp": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
        return {"embed": L.embed_specs(cfg),
                "pos_dec": spec((max_dec_positions, cfg.d_model), cfg.param_dtype),
                "enc_layers": stacked(enc, cfg.enc_layers),
                "enc_norm": L.norm_specs(cfg),
                "dec_layers": stacked(dec, cfg.dec_layers),
                "final_norm": L.norm_specs(cfg)}

    def init_params(self, generator: torch.Generator, *, device=None, out: Params = None,
                    max_dec_positions: int = 32776) -> Params:
        """Random parameters (:func:`~repro_torch.models.common.init_tree`);
        ``out``, e.g. the weights arena's views, is filled in place."""
        return init_tree(self.param_specs(max_dec_positions), generator, device=device, out=out)

    # ------------------------------------------------------------- cache
    def cache_specs(self, batch: int, max_len: int, enc_len: int) -> Params:
        """The decoder's self-attention K/V cache and the cross K/V of
        ``enc_len`` encoder positions, per decoder layer and slot."""
        cfg = self.cfg
        cross = spec((cfg.dec_layers, batch, cfg.n_heads, enc_len, cfg.head_dim), cfg.dtype)
        return {"self": L.kv_cache_specs(cfg, cfg.dec_layers, batch, max_len),
                "cross_k": cross, "cross_v": cross}

    def init_cache(self, batch: int, max_len: int, enc_len: int, device=None) -> Params:
        return self.reset_cache(alloc_tree(self.cache_specs(batch, max_len, enc_len), device))

    @staticmethod
    def reset_cache(cache: Params) -> Params:
        """Empty a cache in place: zero K/V, every slot position -1."""
        for name, t in tree_flatten(cache):
            t.fill_(-1 if name.endswith("['kpos']") else 0)
        return cache

    @staticmethod
    def _layer(tree: Params, i: int) -> Params:
        return tree_map(lambda a: a[i], tree)

    # ------------------------------------------------------------ encoder
    def _norms(self, ps: List[Params], xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [L.apply_norm(n, xl, self.cfg) for n, xl in zip(ps, xs)]

    def _enc_layer(self, p: Params, x: torch.Tensor, positions: torch.Tensor,
                   group: Optional[ModelGroup] = None) -> torch.Tensor:
        cfg = self.cfg
        if group is not None:
            attn = L.attention_full(tp.sub(p, "attn"), self._norms(tp.sub(p, "ln_attn"), x), cfg,
                                    positions, causal=False, group=group)
            x = [xl + a for xl, a in zip(x, attn)]
            y = L.apply_mlp(tp.sub(p, "mlp"), self._norms(tp.sub(p, "ln_mlp"), x), cfg, group)
            return [xl + yl for xl, yl in zip(x, y)]
        h = L.apply_norm(p["ln_attn"], x, cfg)
        x = x + L.attention_full(p["attn"], h, cfg, positions, causal=False)
        h = L.apply_norm(p["ln_mlp"], x, cfg)
        return x + L.apply_mlp(p["mlp"], h, cfg)

    def encode(self, params: Params, frames: torch.Tensor,
               group: Optional[ModelGroup] = None) -> torch.Tensor:
        """frames: (B, T_enc, D) stub embeddings -> encoder states, in the
        activation dtype (the frames are cast before the positions are
        added, as in the JAX package).  With ``cfg.remat`` and autograd on,
        each layer runs under non-reentrant ``torch.utils.checkpoint``, as
        the reference wraps its scan body in ``jax.checkpoint``.  With
        ``group`` (``params`` a tree a lane), a list of the lanes' copies:
        each layer's attention and MLP on each lane's heads and columns
        (:func:`~repro_torch.models.layers.attention_full`,
        :func:`~repro_torch.models.layers.apply_mlp`), remat only where the
        lanes share a device."""
        cfg = self.cfg
        b, t, d = frames.shape
        remat = cfg.remat and torch.is_grad_enabled()
        if group is not None:
            x = [frames.to(dev, cfg.adtype) + sinusoids(t, d, dev).to(cfg.adtype)[None]
                 for dev in group.devices]
            positions = [torch.arange(t, dtype=torch.int32, device=xl.device).expand(b, t)
                         for xl in x]
            stacks = [unstacked(e, cfg.enc_layers) for e in tp.sub(params, "enc_layers")]
            for i in range(cfg.enc_layers):
                x = remat_call(remat and group.one_device, self._enc_layer,
                               [st[i] for st in stacks], x, positions, group)
            return self._norms(tp.sub(params, "enc_norm"), x)
        x = frames.to(cfg.adtype) + sinusoids(t, d, frames.device).to(cfg.adtype)[None]
        positions = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
        for p in unstacked(params["enc_layers"], cfg.enc_layers):
            x = remat_call(remat, self._enc_layer, p, x, positions)
        return L.apply_norm(params["enc_norm"], x, cfg)

    # ------------------------------------------------------------ decoder
    def _embed_dec(self, params: Params, tokens: torch.Tensor,
                   group: Optional[ModelGroup] = None) -> torch.Tensor:
        """Token embeddings plus the learned positions 0 .. S - 1 (with
        ``group``, the vocabulary-parallel lookup, a copy a lane)."""
        s, adtype = tokens.shape[1], self.cfg.adtype
        if group is not None:
            x = L.embed_tokens(tp.sub(params, "embed"), tokens, self.cfg, group)
            return [xl + pl["pos_dec"][:s][None].to(adtype) for pl, xl in zip(params, x)]
        return L.embed_tokens(params["embed"], tokens, self.cfg) + \
            params["pos_dec"][:s][None].to(adtype)

    def _dec_layer(self, p: Params, x: torch.Tensor, enc: torch.Tensor,
                   positions: torch.Tensor, group: Optional[ModelGroup] = None) -> torch.Tensor:
        cfg = self.cfg
        if group is not None:
            attn = L.attention_full(tp.sub(p, "self_attn"), self._norms(tp.sub(p, "ln_self"), x),
                                    cfg, positions, causal=True, group=group)
            x = [xl + a for xl, a in zip(x, attn)]
            y = cross_attention_lanes(tp.sub(p, "cross_attn"), self._norms(
                tp.sub(p, "ln_cross"), x), enc, cfg, group)
            x = [xl + yl for xl, yl in zip(x, y)]
            y = L.apply_mlp(tp.sub(p, "mlp"), self._norms(tp.sub(p, "ln_mlp"), x), cfg, group)
            return [xl + yl for xl, yl in zip(x, y)]
        h = L.apply_norm(p["ln_self"], x, cfg)
        x = x + L.attention_full(p["self_attn"], h, cfg, positions, causal=True)
        h = L.apply_norm(p["ln_cross"], x, cfg)
        ck, cv = cross_kv(p["cross_attn"], enc, cfg)
        x = x + cross_attention(p["cross_attn"], h, ck, cv, cfg)
        h = L.apply_norm(p["ln_mlp"], x, cfg)
        return x + L.apply_mlp(p["mlp"], h, cfg)

    def decode_full(self, params: Params, tokens: torch.Tensor, enc: torch.Tensor,
                    group: Optional[ModelGroup] = None) -> torch.Tensor:
        """Teacher-forced decoder forward of tokens (B, S) over encoder
        states ``enc`` (B, T_enc, D) -> logits (B, S, V) f32; each layer
        rematerialised as in :meth:`encode`.  With ``group`` (``params`` a
        tree a lane, ``enc`` a copy a lane), the lanes' (B, S, V/M) logit
        columns."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self._embed_dec(params, tokens, group)
        remat = cfg.remat and torch.is_grad_enabled()
        if group is not None:
            positions = [torch.arange(s, dtype=torch.int32, device=xl.device).expand(b, s)
                         for xl in x]
            stacks = [unstacked(t, cfg.dec_layers) for t in tp.sub(params, "dec_layers")]
            for i in range(cfg.dec_layers):
                x = remat_call(remat and group.one_device, self._dec_layer,
                               [st[i] for st in stacks], x, enc, positions, group)
            x = self._norms(tp.sub(params, "final_norm"), x)
            return L.logits_from_hidden(tp.sub(params, "embed"), x, cfg, group)
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        for p in unstacked(params["dec_layers"], cfg.dec_layers):
            x = remat_call(remat, self._dec_layer, p, x, enc, positions)
        x = L.apply_norm(params["final_norm"], x, cfg)
        return L.logits_from_hidden(params["embed"], x, cfg)

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor],
                group: Optional[ModelGroup] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of a batch: frames (B, T_enc, D), tokens (B, S),
        labels (B, S) [, loss_mask (B, S)]; the mean token cross-entropy
        of the teacher-forced decoder over the encoded frames (with
        ``group`` the vocabulary-parallel one, on the group's first
        device)."""
        enc = self.encode(params, batch["frames"], group)
        logits = self.decode_full(params, batch["tokens"], enc, group)
        loss = L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"), group)
        return loss, {"loss": loss}

    # ------------------------------------------------------------- serve
    def prefill(self, params: Params, frames: torch.Tensor, tokens: torch.Tensor,
                cache: Params) -> Tuple[torch.Tensor, Params]:
        """Encode the audio, then :meth:`prefill_from_enc`."""
        return self.prefill_from_enc(params, self.encode(params, frames), tokens, cache)

    def prefill_from_enc(self, params: Params, enc: torch.Tensor, tokens: torch.Tensor,
                         cache: Params) -> Tuple[torch.Tensor, Params]:
        """Decoder prefill of a prompt (B, S) from encoder states ``enc``
        (B, T_enc, D): fills the self-attention cache and each layer's
        cross K/V in place; returns (last-token logits (B, 1, V) f32,
        cache).  Split out of :meth:`prefill` so a Pipeline runs the
        encoder as its own node and joins its ``enc`` edge here."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self._embed_dec(params, tokens)
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        for i in range(cfg.dec_layers):
            p = self._layer(params["dec_layers"], i)
            h = L.apply_norm(p["ln_self"], x, cfg)
            attn, _ = L.prefill_kv(p["self_attn"], h, cfg, positions,
                                   self._layer(cache["self"], i))
            x = x + attn
            ck, cv = cross_kv(p["cross_attn"], enc, cfg)
            h = L.apply_norm(p["ln_cross"], x, cfg)
            x = x + cross_attention(p["cross_attn"], h, ck, cv, cfg)
            h = L.apply_norm(p["ln_mlp"], x, cfg)
            x = x + L.apply_mlp(p["mlp"], h, cfg)
            cache["cross_k"][i].copy_(ck.to(cfg.adtype))
            cache["cross_v"][i].copy_(cv.to(cfg.adtype))
        x = L.apply_norm(params["final_norm"], x[:, -1:].contiguous(), cfg)
        return L.logits_from_hidden(params["embed"], x, cfg), cache

    def decode_step(self, params: Params, token: torch.Tensor, pos,
                    cache: Params) -> Tuple[torch.Tensor, Params]:
        """token: (B, 1) int; pos: position of this token, shared by the
        batch (a 0-d tensor on the device, or an int): it picks the learned
        position and the cache slot.  Returns (logits (B, 1, V) f32, cache)."""
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], token, cfg)
        if not isinstance(pos, torch.Tensor):
            pos = torch.tensor(pos, dtype=torch.int32, device=x.device)
        x = x + params["pos_dec"].index_select(0, pos.view(1).long())[None].to(cfg.adtype)
        for i in range(cfg.dec_layers):
            p = self._layer(params["dec_layers"], i)
            h = L.apply_norm(p["ln_self"], x, cfg)
            attn, _ = L.attention_decode(p["self_attn"], h, cfg, pos,
                                         self._layer(cache["self"], i))
            x = x + attn
            h = L.apply_norm(p["ln_cross"], x, cfg)
            x = x + cross_attention(p["cross_attn"], h, cache["cross_k"][i],
                                    cache["cross_v"][i], cfg)
            h = L.apply_norm(p["ln_mlp"], x, cfg)
            x = x + L.apply_mlp(p["mlp"], h, cfg)
        x = L.apply_norm(params["final_norm"], x, cfg)
        return L.logits_from_hidden(params["embed"], x, cfg), cache

    def cache_partition_rules(self) -> Rules:
        """Where the port's decode puts each cache leaf (the JAX package's
        ``cache_partition_rules`` names its sequence-over-``model``
        layout, which the port never runs): the slot axis over the
        batch's axes and then ``model``, each lane of a model group
        decoding its strip of slots (``DecodeStep``); where the slots do
        not divide, the dry run's fit leaves them replicated over
        ``model``."""
        return [(r"self|cross_k|cross_v", (None, SLOT_AXES))]

    def partition_rules(self) -> Rules:
        """The JAX package's rule table."""
        lay: Rules = [
            (r"w_q|w_k|w_v", (None, MODEL)),
            (r"b_q|b_k|b_v", (MODEL,)),
            (r"w_o", (MODEL, None)),
            (r"w_gate|w_up", (None, MODEL)),
            (r"b_up", (MODEL,)),
            (r"w_down", (MODEL, None)),
        ]
        rules: Rules = [
            (r"embed.*embedding", (MODEL, None)),
            (r"embed.*unembed", (None, MODEL)),
            (r"pos_dec", ()),
        ]
        rules += [(rf"(enc|dec)_layers.*(?:{pat})", (None,) + spec) for pat, spec in lay]
        return rules
