"""Zamba2-style hybrid, the hybrid family (zamba2-2.7b): a Mamba2 backbone
with one SHARED attention block applied every ``attn_every`` layers.

Mirrors ``repro/models/zamba2.py``.  ``n_super = n_layers / attn_every``
superblocks, each the shared attention + MLP block (one set of weights,
reused) followed by ``attn_every`` Mamba2 layers, whose weights are stacked
(n_super, per_super, ...).  The JAX nested ``lax.scan`` over superblocks
and layers is two Python loops over views.  (The published model adds
per-invocation LoRA deltas on the shared block and concatenates the
embedding; the reference leaves both out, and so does the port.)

The cache holds the shared block's K/V, one (n_super, B, ...) set per
superblock, and each Mamba2 layer's conv window and SSM state, (n_super,
per_super, B, ...).  ``prefill`` and ``decode_step`` write the cache they
are given (views of the decode-state arena) in place and return it.  A
prefill starts from the cache's SSM state (zeros after
:meth:`reset_cache`), as the reference's does.  The training entry points
``hidden_states`` and ``loss_fn`` write nothing in place (the Mamba2
layers run :func:`~repro_torch.models.mamba2.mamba2_forward`, no cache), so
autograd differentiates them: through the norm and attention kernels'
hand-written backward passes on CUDA tensors, and through the plain f32
SSD.  The shared block's gradient is the sum over its ``n_super`` uses.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from . import layers as L
from . import mamba2 as M2
from . import parallel as tp
from .common import (MODEL, SLOT_AXES, ArchConfig, Rules, alloc_tree, init_tree, remat_call, stacked,
                     tree_map, unstacked)
from .parallel import ModelGroup
from .transformer import DecoderLM

Params = Dict[str, Any]


class Zamba2Model:
    """Functional model object: parameters and caches are nested dicts."""

    #: the kernel modules a forward launches (loaded by the LM processes):
    #: the norms and the shared block's attention; the SSD is plain torch
    kernel_names = ("rmsnorm", "flash_attention")

    def __init__(self, cfg: ArchConfig):
        if not cfg.attn_every or cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
                             f"attn_every {cfg.attn_every}")
        self.cfg = cfg
        self.n_super = cfg.n_layers // cfg.attn_every
        self.per_super = cfg.attn_every

    def _stacked(self, specs: Params) -> Params:
        """(n_super, per_super, ...) stacks of per-layer specs."""
        return stacked(stacked(specs, self.per_super), self.n_super)

    # ------------------------------------------------------------- params
    def param_specs(self) -> Params:
        """Shapes and dtypes of the parameter tree, nothing allocated."""
        cfg = self.cfg
        shared = {"ln_attn": L.norm_specs(cfg), "attn": L.attention_specs(cfg),
                  "ln_mlp": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
        layer = {"ln": L.norm_specs(cfg), "mamba": M2.mamba2_specs(cfg)}
        return {"embed": L.embed_specs(cfg), "shared": shared,
                "mamba_layers": self._stacked(layer), "final_norm": L.norm_specs(cfg)}

    def init_params(self, generator: torch.Generator, *, device=None,
                    out: Optional[Params] = None) -> Params:
        """Random parameters (:func:`~repro_torch.models.common.init_tree`);
        ``out``, e.g. the weights arena's views, is filled in place."""
        return init_tree(self.param_specs(), generator, device=device, out=out)

    # ------------------------------------------------------------- cache
    def cache_specs(self, batch: int, max_len: int) -> Params:
        cfg = self.cfg
        return {"kv": L.kv_cache_specs(cfg, self.n_super, batch, max_len),
                "ssm": self._stacked(M2.mamba2_state_specs(cfg, batch))}

    def init_cache(self, batch: int, max_len: int, device=None) -> Params:
        return self.reset_cache(alloc_tree(self.cache_specs(batch, max_len), device))

    #: zero K/V, conv windows and SSM states, every slot position -1: a
    #: prefill through a reset row cache starts from the zero state
    reset_cache = staticmethod(DecoderLM.reset_cache)

    # ------------------------------------------------------------- serve
    def _superblocks(self, params: Params, cache: Params) -> Iterator[Tuple[Params, Params,
                                                                            list]]:
        """(shared-block cache, [(Mamba2 layer parameters, layer state)])
        of each superblock, all views."""
        for i in range(self.n_super):
            layers = [(tree_map(lambda a: a[i, j], params["mamba_layers"]),
                       tree_map(lambda a: a[i, j], cache["ssm"]))
                      for j in range(self.per_super)]
            yield tree_map(lambda a: a[i], cache["kv"]), layers

    def _shared_mlp(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        return x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln_mlp"], x, self.cfg), self.cfg)

    def prefill(self, params: Params, tokens: torch.Tensor,
                cache: Params) -> Tuple[torch.Tensor, Params]:
        """Fill the cache with a full prompt (B, S); returns (last-token
        logits (B, 1, V) f32, cache)."""
        cfg = self.cfg
        shared = params["shared"]
        x = L.embed_tokens(params["embed"], tokens, cfg)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        for kv, layers in self._superblocks(params, cache):
            h = L.apply_norm(shared["ln_attn"], x, cfg)
            attn, _ = L.prefill_kv(shared["attn"], h, cfg, positions, kv)
            x = self._shared_mlp(shared, x + attn)
            for lp, st in layers:
                out, conv, ssm = M2.mamba2_scan(lp["mamba"], L.apply_norm(lp["ln"], x, cfg),
                                                cfg, st["ssm"])
                st["conv"].copy_(conv)
                st["ssm"].copy_(ssm)
                x = x + out
        x = L.apply_norm(params["final_norm"], x[:, -1:].contiguous(), cfg)
        return L.logits_from_hidden(params["embed"], x, cfg), cache

    def decode_step(self, params: Params, token: torch.Tensor, pos,
                    cache: Params) -> Tuple[torch.Tensor, Params]:
        """token: (B, 1) int; pos: position of this token (a 0-d tensor on
        the device, or an int).  Returns (logits (B, 1, V) f32, cache)."""
        cfg = self.cfg
        shared = params["shared"]
        x = L.embed_tokens(params["embed"], token, cfg)
        if not isinstance(pos, torch.Tensor):
            pos = torch.tensor(pos, dtype=torch.int32, device=x.device)
        for kv, layers in self._superblocks(params, cache):
            h = L.apply_norm(shared["ln_attn"], x, cfg)
            attn, _ = L.attention_decode(shared["attn"], h, cfg, pos, kv)
            x = self._shared_mlp(shared, x + attn)
            for lp, st in layers:
                out, _ = M2.mamba2_step(lp["mamba"], L.apply_norm(lp["ln"], x, cfg), cfg, st)
                x = x + out
        x = L.apply_norm(params["final_norm"], x, cfg)
        return L.logits_from_hidden(params["embed"], x, cfg), cache

    # ------------------------------------------------------------- train
    def _superblock_fwd(self, shared: Params, layers: list, x: torch.Tensor,
                        positions: torch.Tensor,
                        group: Optional[ModelGroup] = None) -> torch.Tensor:
        """The shared attention + MLP block, then the superblock's Mamba2
        layers, each ``x + mamba2_forward(ln(x))``; with ``group``, each
        argument a list a lane, the attention and MLP on each lane's heads
        and columns and the Mamba2 layers on its SSD heads."""
        cfg = self.cfg
        if group is not None:
            def norms(ps, xs):
                return [L.apply_norm(n, xl, cfg) for n, xl in zip(ps, xs)]

            attn = L.attention_full(tp.sub(shared, "attn"), norms(tp.sub(shared, "ln_attn"), x),
                                    cfg, positions, group=group)
            x = [xl + a for xl, a in zip(x, attn)]
            y = L.apply_mlp(tp.sub(shared, "mlp"), norms(tp.sub(shared, "ln_mlp"), x), cfg, group)
            x = [xl + yl for xl, yl in zip(x, y)]
            for lp in layers:
                y = M2.mamba2_forward_lanes(tp.sub(lp, "mamba"), norms(tp.sub(lp, "ln"), x), cfg,
                                            group)
                x = [xl + yl for xl, yl in zip(x, y)]
            return x
        h = L.apply_norm(shared["ln_attn"], x, cfg)
        x = self._shared_mlp(shared, x + L.attention_full(shared["attn"], h, cfg, positions))
        for lp in layers:
            x = x + M2.mamba2_forward(lp["mamba"], L.apply_norm(lp["ln"], x, cfg), cfg)
        return x

    def hidden_states(self, params: Params, tokens: torch.Tensor,
                      group: Optional[ModelGroup] = None) -> torch.Tensor:
        """Full-sequence forward from zero states to the final hidden
        states (B, S, D).  With ``cfg.remat`` and autograd on, each
        superblock runs under non-reentrant ``torch.utils.checkpoint``, as
        the reference wraps its superblock in ``jax.checkpoint``.  With
        ``group`` (``params`` a tree a lane), a list of the lanes' copies:
        the shared block tensor parallel as ``DecoderLM``'s layers, the
        Mamba2 layers over the lanes' SSD heads
        (:func:`~repro_torch.models.mamba2.mamba2_forward_lanes`), remat
        only where the lanes share a device."""
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        if group is not None:
            x = L.embed_tokens(tp.sub(params, "embed"), tokens, cfg, group)
            b, s, _ = x[0].shape
            positions = [torch.arange(s, dtype=torch.int32, device=xl.device).expand(b, s)
                         for xl in x]
            stacks = [[unstacked(sp, self.per_super) for sp in unstacked(t, self.n_super)]
                      for t in tp.sub(params, "mamba_layers")]
            for i in range(self.n_super):
                layers = [[st[i][j] for st in stacks] for j in range(self.per_super)]
                x = remat_call(remat and group.one_device, self._superblock_fwd,
                               tp.sub(params, "shared"), layers, x, positions, group)
            return [L.apply_norm(n, xl, cfg) for n, xl in zip(tp.sub(params, "final_norm"), x)]
        x = L.embed_tokens(params["embed"], tokens, cfg)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        for sp in unstacked(params["mamba_layers"], self.n_super):
            x = remat_call(remat, self._superblock_fwd, params["shared"],
                           unstacked(sp, self.per_super), x, positions)
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
        return [(r"\['kv'\]", (None, SLOT_AXES)), (r"\['ssm'\]", (None, None, SLOT_AXES))]

    def partition_rules(self) -> Rules:
        """The JAX package's rule table (the Mamba2 stack has two leading
        stack dims: superblock, layer in the superblock)."""
        rules: Rules = [
            (r"embed.*embedding", (MODEL, None)),
            (r"embed.*unembed", (None, MODEL)),
            (r"shared.*w_q|shared.*w_k|shared.*w_v", (None, MODEL)),
            (r"shared.*w_o", (MODEL, None)),
            (r"shared.*w_gate|shared.*w_up", (None, MODEL)),
            (r"shared.*w_down", (MODEL, None)),
        ]
        rules += [(rf"mamba_layers.*(?:{pat})", (None, None) + spec)
                  for pat, spec in M2.mamba2_partition_rules()]
        return rules
