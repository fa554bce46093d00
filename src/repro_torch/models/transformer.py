"""Decoder-only LM, dense family (qwen3 / qwen2 / h2o-danube / minitron).

Mirrors the dense path of ``repro/models/transformer.py``: the stacked
``(L, ...)`` parameter layout is kept, and the JAX ``lax.scan`` over layers
is a Python loop over layer views.  Serving entry points only: ``prefill``
and ``decode_step`` write the cache they are given in place (views of the
decode-state arena) and return it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import layers as L
from .common import ArchConfig, alloc_tree, init_tree, stacked, tree_flatten, tree_map

Params = Dict[str, Any]

#: where the DecoderLM parts not ported yet stand in ROADMAP queue 1
_LATER = "not ported yet (ROADMAP queue 1, rest of the LM stack)"
_TRAINING = "the training forward is not ported yet (ROADMAP queue 1, Training)"


class DecoderLM:
    """Functional model object: parameters and caches are nested dicts."""

    #: the kernel modules a forward launches (loaded by the LM processes)
    kernel_names = ("rmsnorm", "flash_attention")

    def __init__(self, cfg: ArchConfig):
        if cfg.mla or cfg.n_experts or cfg.first_dense_ff:
            raise NotImplementedError(f"{cfg.name}: MLA and MoE layers are {_LATER}")
        self.cfg = cfg

    # ------------------------------------------------------------- params
    def param_specs(self) -> Params:
        """Shapes and dtypes of the parameter tree, nothing allocated."""
        cfg = self.cfg
        layer = {"ln_attn": L.norm_specs(cfg), "ln_mlp": L.norm_specs(cfg),
                 "attn": L.attention_specs(cfg), "mlp": L.mlp_specs(cfg)}
        return {"embed": L.embed_specs(cfg),
                "layers": stacked(layer, cfg.n_layers),
                "final_norm": L.norm_specs(cfg)}

    def init_params(self, generator: torch.Generator, *, device=None,
                    out: Optional[Params] = None) -> Params:
        """Random parameters (:func:`~repro_torch.models.common.init_tree`);
        ``out``, e.g. the weights arena's views, is filled in place."""
        return init_tree(self.param_specs(), generator, device=device, out=out)

    # ------------------------------------------------------------- cache
    def cache_specs(self, batch: int, max_len: int) -> Params:
        return {"scan": L.kv_cache_specs(self.cfg, self.cfg.n_layers, batch, max_len)}

    def init_cache(self, batch: int, max_len: int, device=None) -> Params:
        return self.reset_cache(alloc_tree(self.cache_specs(batch, max_len), device))

    @staticmethod
    def reset_cache(cache: Params) -> Params:
        """Empty a cache in place: zero K/V, every slot position -1."""
        for name, t in tree_flatten(cache):
            t.fill_(-1 if name.endswith("['kpos']") else 0)
        return cache

    # ------------------------------------------------------------- serve
    @staticmethod
    def _layer(tree: Params, i: int) -> Params:
        return tree_map(lambda a: a[i], tree)

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params,
                prefix_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Params]:
        """Fill the cache with a full prompt (B, S); returns (last-token
        logits (B, 1, V) f32, cache)."""
        if prefix_embeds is not None:
            raise NotImplementedError(f"the VLM patch prefix is {_LATER}")
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], tokens, cfg)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        for i in range(cfg.n_layers):
            p = self._layer(params["layers"], i)
            h = L.apply_norm(p["ln_attn"], x, cfg)
            attn, _ = L.prefill_kv(p["attn"], h, cfg, positions, self._layer(cache["scan"], i))
            x = x + attn
            h = L.apply_norm(p["ln_mlp"], x, cfg)
            x = x + L.apply_mlp(p["mlp"], h, cfg)
        x = L.apply_norm(params["final_norm"], x[:, -1:].contiguous(), cfg)
        return L.logits_from_hidden(params["embed"], x, cfg), cache

    def decode_step(self, params: Params, token: torch.Tensor, pos, cache: Params,
                    ) -> Tuple[torch.Tensor, Params]:
        """token: (B, 1) int; pos: position of this token (a 0-d tensor on
        the device, or an int).  Returns (logits (B, 1, V) f32, cache)."""
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], token, cfg)
        if not isinstance(pos, torch.Tensor):
            pos = torch.tensor(pos, dtype=torch.int32, device=x.device)
        for i in range(cfg.n_layers):
            p = self._layer(params["layers"], i)
            h = L.apply_norm(p["ln_attn"], x, cfg)
            attn, _ = L.attention_decode(p["attn"], h, cfg, pos, self._layer(cache["scan"], i))
            x = x + attn
            h = L.apply_norm(p["ln_mlp"], x, cfg)
            x = x + L.apply_mlp(p["mlp"], h, cfg)
        x = L.apply_norm(params["final_norm"], x, cfg)
        return L.logits_from_hidden(params["embed"], x, cfg), cache

    # ------------------------------------------------------------- train
    def logits(self, params, tokens, prefix_embeds=None):
        raise NotImplementedError(_TRAINING)

    def loss_fn(self, params, batch):
        raise NotImplementedError(_TRAINING)
