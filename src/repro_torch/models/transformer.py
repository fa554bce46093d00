"""Decoder-only LM: the dense (qwen3 / qwen2 / h2o-danube / minitron), MoE
(granite; deepseek-v2-lite with MLA attention and a dense layer 0) and VLM
(internvl2: patch embeddings in front of the prompt's) families.

Mirrors ``repro/models/transformer.py``: the stacked ``(L, ...)``
parameter layout is kept, and the JAX ``lax.scan`` over layers is a Python
loop over layer views.  The serving entry points ``prefill`` and
``decode_step`` write the cache they are given in place (views of the
decode-state arena) and return it; the training entry points
``hidden_states``, ``logits`` and ``loss_fn`` write nothing in place, so
autograd differentiates them (through the norm and attention kernels'
hand-written backward passes on CUDA tensors).

The training entry points also run over the lanes of a model group
(``group=``, :mod:`~repro_torch.models.parallel`), tensor parallel by
:meth:`DecoderLM.partition_rules`: the parameters are then a list of the
lanes' pieces (a tree a lane), the hidden states a list of the lanes'
copies, the logits a list of the lanes' vocabulary columns, and the loss
the vocabulary-parallel cross-entropy.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import parallel as tp
from .common import (MODEL, SLOT_AXES, ArchConfig, Rules, alloc_tree, init_tree, remat_call, stacked,
                     tree_flatten, tree_map, unstacked)
from .parallel import ModelGroup

Params = Dict[str, Any]


class DecoderLM:
    """Functional model object: parameters and caches are nested dicts.

    Layer 0 of a config with ``first_dense_ff`` (deepseek) is a dense-FFN
    layer of width ``first_dense_ff`` outside the stack, its parameters and
    cache the unstacked ``layer0`` subtrees; the stacked ``layers`` /
    ``scan`` subtrees hold the other ``n_layers - 1``."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.n_scan = cfg.n_layers - (1 if cfg.first_dense_ff else 0)

    @property
    def kernel_names(self) -> Tuple[str, ...]:
        """The kernel modules a forward launches (loaded by the LM
        processes): MLA attention is plain torch, so it launches no
        flash attention."""
        return ("rmsnorm",) if self.cfg.mla else ("rmsnorm", "flash_attention")

    # ------------------------------------------------------------- params
    def _layer_specs(self, *, moe: bool, d_ff: Optional[int] = None) -> Params:
        cfg = self.cfg
        p = {"ln_attn": L.norm_specs(cfg), "ln_mlp": L.norm_specs(cfg),
             "attn": MLA.mla_specs(cfg) if cfg.mla else L.attention_specs(cfg)}
        if moe:
            p["moe"] = MOE.moe_specs(cfg)
        else:
            p["mlp"] = L.mlp_specs(cfg, d_ff)
        return p

    def param_specs(self) -> Params:
        """Shapes and dtypes of the parameter tree, nothing allocated."""
        cfg = self.cfg
        specs = {"embed": L.embed_specs(cfg),
                 "layers": stacked(self._layer_specs(moe=bool(cfg.n_experts)), self.n_scan),
                 "final_norm": L.norm_specs(cfg)}
        if cfg.first_dense_ff:
            specs["layer0"] = self._layer_specs(moe=False, d_ff=cfg.first_dense_ff)
        return specs

    def init_params(self, generator: torch.Generator, *, device=None,
                    out: Optional[Params] = None) -> Params:
        """Random parameters (:func:`~repro_torch.models.common.init_tree`);
        ``out``, e.g. the weights arena's views, is filled in place."""
        return init_tree(self.param_specs(), generator, device=device, out=out)

    # ------------------------------------------------------------- cache
    def cache_specs(self, batch: int, max_len: int) -> Params:
        cfg = self.cfg
        specs_of = MLA.mla_cache_specs if cfg.mla else L.kv_cache_specs
        specs = {"scan": specs_of(cfg, self.n_scan, batch, max_len)}
        if cfg.first_dense_ff:
            specs["layer0"] = tree_map(lambda s: type(s)(tuple(s.shape[1:]), s.dtype),
                                       specs_of(cfg, 1, batch, max_len))
        return specs

    def init_cache(self, batch: int, max_len: int, device=None) -> Params:
        return self.reset_cache(alloc_tree(self.cache_specs(batch, max_len), device))

    @staticmethod
    def reset_cache(cache: Params) -> Params:
        """Empty a cache in place: zero K/V (or latents), every slot
        position -1."""
        for name, t in tree_flatten(cache):
            t.fill_(-1 if name.endswith("['kpos']") else 0)
        return cache

    # ------------------------------------------------------------- serve
    def _layers(self, params: Params, cache: Params):
        """(layer parameters, layer cache) in order: layer 0, then the
        stacked layers (views of one index of each leaf)."""
        if self.cfg.first_dense_ff:
            yield params["layer0"], cache["layer0"]
        for i in range(self.n_scan):
            yield (tree_map(lambda a: a[i], params["layers"]),
                   tree_map(lambda a: a[i], cache["scan"]))

    def _ffn(self, p: Params, h: torch.Tensor) -> torch.Tensor:
        if "moe" in p:
            return MOE.moe_forward(p["moe"], h, self.cfg)
        return L.apply_mlp(p["mlp"], h, self.cfg)

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params,
                prefix_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Params]:
        """Fill the cache with a full prompt (B, S); returns (last-token
        logits (B, 1, V) f32, cache).  ``prefix_embeds`` (B, P, D), e.g. a
        VLM's patch embeddings, cast to the activation dtype, go in front
        of the token embeddings: positions then run over P + S and the
        cache holds P + S entries."""
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], tokens, cfg)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(cfg.adtype), x], dim=1)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        attend = MLA.mla_prefill if cfg.mla else L.prefill_kv
        for p, lcache in self._layers(params, cache):
            h = L.apply_norm(p["ln_attn"], x, cfg)
            attn, _ = attend(p["attn"], h, cfg, positions, lcache)
            x = x + attn
            x = x + self._ffn(p, L.apply_norm(p["ln_mlp"], x, cfg))
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
        attend = MLA.mla_decode if cfg.mla else L.attention_decode
        for p, lcache in self._layers(params, cache):
            h = L.apply_norm(p["ln_attn"], x, cfg)
            attn, _ = attend(p["attn"], h, cfg, pos, lcache)
            x = x + attn
            x = x + self._ffn(p, L.apply_norm(p["ln_mlp"], x, cfg))
        x = L.apply_norm(params["final_norm"], x, cfg)
        return L.logits_from_hidden(params["embed"], x, cfg), cache

    # ------------------------------------------------------------- train
    def _layer_fwd(self, p: Params, x: torch.Tensor, positions: torch.Tensor, use_moe: bool,
                   group: Optional[ModelGroup] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        if group is not None:
            return self._layer_fwd_lanes(p, x, positions, use_moe, group)
        h = L.apply_norm(p["ln_attn"], x, cfg)
        if cfg.mla:
            attn = MLA.mla_full(p["attn"], h, cfg, positions)
        else:
            attn = L.attention_full(p["attn"], h, cfg, positions, causal=cfg.causal)
        x = x + attn
        h = L.apply_norm(p["ln_mlp"], x, cfg)
        if use_moe:
            y, aux = MOE.apply_moe(p["moe"], h, cfg)
        else:
            y, aux = L.apply_mlp(p["mlp"], h, cfg), {}
        return x + y, aux

    def _layer_fwd_lanes(self, p, x, positions, use_moe: bool, group: ModelGroup):
        """One layer over the group's lanes: the norms and residual adds on
        every lane's copy, the attention and the MLP or experts on each
        lane's pieces (one reduce each)."""
        cfg = self.cfg

        def sub(key):
            return [pl[key] for pl in p]

        h = [L.apply_norm(n, xl, cfg) for n, xl in zip(sub("ln_attn"), x)]
        if cfg.mla:
            attn = MLA.mla_full(sub("attn"), h, cfg, positions, group)
        else:
            attn = L.attention_full(sub("attn"), h, cfg, positions, causal=cfg.causal,
                                    group=group)
        x = [xl + a for xl, a in zip(x, attn)]
        h = [L.apply_norm(n, xl, cfg) for n, xl in zip(sub("ln_mlp"), x)]
        if use_moe:
            y, aux = MOE.apply_moe(sub("moe"), h, cfg, group)
        else:
            y, aux = L.apply_mlp(sub("mlp"), h, cfg, group), {}
        return [xl + yl for xl, yl in zip(x, y)], aux

    def hidden_states(self, params: Params, tokens: torch.Tensor,
                      prefix_embeds: Optional[torch.Tensor] = None,
                      group: Optional[ModelGroup] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full-sequence forward to the final hidden states (B, P + S, D)
        and the MoE metrics (``moe_aux_loss``, ``moe_drop_rate``: sums over
        the stacked layers / their count; empty without experts).
        tokens: (B, S); prefix_embeds: (B, P, D), a VLM's patch
        embeddings.  With ``cfg.remat`` and autograd on, each stacked
        layer runs under non-reentrant ``torch.utils.checkpoint`` (its
        activations recomputed in the backward), as the reference wraps
        its scan body in ``jax.checkpoint``; deepseek's layer 0 stays
        outside, as there.  With ``group`` (``params`` a tree a lane), the
        hidden states are a list of the lanes' copies, each MoE metric one
        value (:func:`~repro_torch.models.parallel.single`), and a
        checkpoint holds one whole layer of every lane, so its recompute
        replays the same reduces; a group over distinct cards keeps every
        layer's activations (the same values)."""
        if group is not None:
            return self._hidden_states_lanes(params, tokens, prefix_embeds, group)
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], tokens, cfg)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(cfg.adtype), x], dim=1)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        if cfg.first_dense_ff:
            x, _ = self._layer_fwd(params["layer0"], x, positions, False)
        use_moe = bool(cfg.n_experts)
        remat = cfg.remat and torch.is_grad_enabled()
        aux_sums = None
        for lp in unstacked(params["layers"], self.n_scan):
            x, aux = remat_call(remat, self._layer_fwd, lp, x, positions, use_moe)
            if use_moe:
                aux_sums = aux if aux_sums is None else {k: aux_sums[k] + aux[k] for k in aux}
        x = L.apply_norm(params["final_norm"], x, cfg)
        if not use_moe:
            return x, {}
        n_moe = max(1, self.n_scan)
        return x, {k: v / n_moe for k, v in aux_sums.items()}

    def _hidden_states_lanes(self, params, tokens, prefix_embeds, group: ModelGroup):
        """:meth:`hidden_states` over the group's lanes (``params`` a tree a
        lane)."""
        cfg = self.cfg

        def sub(key):
            return [pl[key] for pl in params]

        x = L.embed_tokens(sub("embed"), tokens, cfg, group)
        if prefix_embeds is not None:
            x = [torch.cat([prefix_embeds.to(xl.device, cfg.adtype), xl], dim=1) for xl in x]
        b, s, _ = x[0].shape
        positions = [torch.arange(s, dtype=torch.int32, device=xl.device).expand(b, s)
                     for xl in x]
        if cfg.first_dense_ff:
            x, _ = self._layer_fwd(sub("layer0"), x, positions, False, group)
        use_moe = bool(cfg.n_experts)
        remat = cfg.remat and torch.is_grad_enabled() and group.one_device
        aux_sums = None
        stacks = [unstacked(layers, self.n_scan) for layers in sub("layers")]
        for i in range(self.n_scan):
            x, aux = remat_call(remat, self._layer_fwd, [st[i] for st in stacks], x, positions,
                                use_moe, group)
            if use_moe:
                aux_sums = aux if aux_sums is None else {
                    k: [a + b for a, b in zip(aux_sums[k], aux[k])] for k in aux}
        x = [L.apply_norm(n, xl, cfg) for n, xl in zip(sub("final_norm"), x)]
        if not use_moe:
            return x, {}
        n_moe = max(1, self.n_scan)
        return x, {k: tp.single(group, v) / n_moe for k, v in aux_sums.items()}

    def logits(self, params: Params, tokens: torch.Tensor,
               prefix_embeds: Optional[torch.Tensor] = None,
               group: Optional[ModelGroup] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(logits (B, P + S, V) f32, MoE metrics) of a full sequence; with
        ``group``, a list of the lanes' (B, P + S, V/M) columns."""
        x, aux = self.hidden_states(params, tokens, prefix_embeds, group)
        embed = [pl["embed"] for pl in params] if group is not None else params["embed"]
        return L.logits_from_hidden(embed, x, self.cfg, group), aux

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor],
                group: Optional[ModelGroup] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, metrics) of a batch: tokens (B, S), labels (B, S)
        [, patch_embeds (B, P, D)] [, loss_mask (B, S)].  The loss is the
        mean token cross-entropy over the text positions (a VLM prefix is
        left out); the total adds the MoE load-balance loss.  With
        ``group`` (``params`` a tree a lane), the vocabulary-parallel
        cross-entropy on the group's first device."""
        prefix = batch.get("patch_embeds")
        logits, aux = self.logits(params, batch["tokens"], prefix, group)
        if prefix is not None:
            cut = prefix.shape[1]
            logits = [lg[:, cut:] for lg in logits] if group is not None else logits[:, cut:]
        loss = L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"), group)
        total = loss + aux["moe_aux_loss"] if "moe_aux_loss" in aux else loss
        return total, {"loss": loss, **aux}

    # ------------------------------------------------------------ sharding
    def cache_partition_rules(self) -> Rules:
        """Where the port's decode puts each cache leaf (the JAX package's
        ``cache_partition_rules`` names its sequence-over-``model``
        layout, which the port never runs): the slot axis over the
        batch's axes and then ``model``, each lane of a model group
        decoding its strip of slots (``DecodeStep``); where the slots do
        not divide, the dry run's fit leaves them replicated over
        ``model``."""
        if self.cfg.first_dense_ff:
            return [(r"scan", (None, SLOT_AXES)), (r"layer0", (SLOT_AXES,))]
        return [(r"scan", (None, SLOT_AXES))]

    def partition_rules(self) -> Rules:
        """The JAX package's rule table: Megatron-style tensor parallelism
        over ``model`` (experts over ``model`` for MoE)."""
        base: Rules = [
            (r"embed.*embedding", (MODEL, None)),
            (r"embed.*unembed", (None, MODEL)),
        ]
        layer: Rules = [
            # MLA
            (r"attn.*w_uk|attn.*w_uv", (None, MODEL, None)),
            (r"attn.*w_dkv|attn.*w_kr", ()),
            # GQA + MLA share w_q/w_o shapes
            (r"attn.*w_q|attn.*w_k|attn.*w_v", (None, MODEL)),
            (r"attn.*b_q|attn.*b_k|attn.*b_v", (MODEL,)),
            (r"attn.*w_o", (MODEL, None)),
            # MoE: experts over model (EP)
            (r"moe.*router", ()),
            (r"moe.*w_gate|moe.*w_up|moe.*w_down", (MODEL, None, None)),
            (r"moe.*shared.*w_gate|moe.*shared.*w_up", (None, MODEL)),
            (r"moe.*shared.*w_down", (MODEL, None)),
            # dense MLP
            (r"mlp.*w_gate|mlp.*w_up", (None, MODEL)),
            (r"mlp.*w_down", (MODEL, None)),
            (r"mlp.*b_up", (MODEL,)),
        ]
        # shared-expert rules must win over the generic expert rules
        layer.sort(key=lambda r: 0 if "shared" in r[0] else 1)
        rules = base + [(rf"layers.*(?:{pat})", (None,) + spec) for pat, spec in layer]
        rules += [(rf"layer0.*(?:{pat})", spec) for pat, spec in layer]
        return rules
