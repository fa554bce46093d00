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
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels import ref
from . import layers as L
from .common import (MODEL, ArchConfig, Rules, alloc_tree, init_tree, remat_call, stacked,
                     tree_flatten, tree_map, unstacked)
from .layers import _spec as spec

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
    """x: (B, S, D); kc, vc: the encoder's K/V (B, H, T_enc, dh)."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    q = (x @ p["w_q"]).view(b, s, h, dh).transpose(1, 2)
    o = ref.attention(q, kc, vc, causal=False)
    return o.transpose(1, 2).reshape(b, s, h * dh) @ p["w_o"]


def cross_kv(p: Params, enc: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder states (B, T, D) -> cross K, V (B, H, T, dh)."""
    b, t, _ = enc.shape
    h, dh = cfg.n_heads, cfg.head_dim
    k = (enc @ p["w_k"]).view(b, t, h, dh).transpose(1, 2)
    v = (enc @ p["w_v"]).view(b, t, h, dh).transpose(1, 2)
    return k, v


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
    def _enc_layer(self, p: Params, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = L.apply_norm(p["ln_attn"], x, cfg)
        x = x + L.attention_full(p["attn"], h, cfg, positions, causal=False)
        h = L.apply_norm(p["ln_mlp"], x, cfg)
        return x + L.apply_mlp(p["mlp"], h, cfg)

    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T_enc, D) stub embeddings -> encoder states, in the
        activation dtype (the frames are cast before the positions are
        added, as in the JAX package).  With ``cfg.remat`` and autograd on,
        each layer runs under non-reentrant ``torch.utils.checkpoint``, as
        the reference wraps its scan body in ``jax.checkpoint``."""
        cfg = self.cfg
        b, t, d = frames.shape
        x = frames.to(cfg.adtype) + sinusoids(t, d, frames.device).to(cfg.adtype)[None]
        positions = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
        remat = cfg.remat and torch.is_grad_enabled()
        for p in unstacked(params["enc_layers"], cfg.enc_layers):
            x = remat_call(remat, self._enc_layer, p, x, positions)
        return L.apply_norm(params["enc_norm"], x, cfg)

    # ------------------------------------------------------------ decoder
    def _embed_dec(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings plus the learned positions 0 .. S - 1."""
        s = tokens.shape[1]
        return L.embed_tokens(params["embed"], tokens, self.cfg) + \
            params["pos_dec"][:s][None].to(self.cfg.adtype)

    def _dec_layer(self, p: Params, x: torch.Tensor, enc: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = L.apply_norm(p["ln_self"], x, cfg)
        x = x + L.attention_full(p["self_attn"], h, cfg, positions, causal=True)
        h = L.apply_norm(p["ln_cross"], x, cfg)
        ck, cv = cross_kv(p["cross_attn"], enc, cfg)
        x = x + cross_attention(p["cross_attn"], h, ck, cv, cfg)
        h = L.apply_norm(p["ln_mlp"], x, cfg)
        return x + L.apply_mlp(p["mlp"], h, cfg)

    def decode_full(self, params: Params, tokens: torch.Tensor,
                    enc: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder forward of tokens (B, S) over encoder
        states ``enc`` (B, T_enc, D) -> logits (B, S, V) f32; each layer
        rematerialised as in :meth:`encode`."""
        cfg = self.cfg
        x = self._embed_dec(params, tokens)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        remat = cfg.remat and torch.is_grad_enabled()
        for p in unstacked(params["dec_layers"], cfg.dec_layers):
            x = remat_call(remat, self._dec_layer, p, x, enc, positions)
        x = L.apply_norm(params["final_norm"], x, cfg)
        return L.logits_from_hidden(params["embed"], x, cfg)

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of a batch: frames (B, T_enc, D), tokens (B, S),
        labels (B, S) [, loss_mask (B, S)]; the mean token cross-entropy
        of the teacher-forced decoder over the encoded frames."""
        enc = self.encode(params, batch["frames"])
        logits = self.decode_full(params, batch["tokens"], enc)
        loss = L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
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
