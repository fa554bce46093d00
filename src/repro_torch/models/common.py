"""Shared model infrastructure of the port: the architecture config, the
parameter-tree helpers, the partition rules and parameter init.

Parameters and caches are nested dicts of tensors, as the JAX package's
pytrees.  :func:`tree_flatten` walks them in sorted key order (the order
JAX flattens a dict in) and names each leaf by its key path the way
``jax.tree_util.keystr`` does (``['layers']['attn']['w_q']``), so the
port's arena layouts match the JAX package's entry for entry.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.arena import torch_dtype, tree_flatten, tree_unflatten


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture: the fields the decoder (dense, MoE, MLA, VLM),
    RWKV6, Zamba2 (Mamba2) and Whisper paths read, with the JAX package's
    defaults.  ``remat`` (recompute each layer's activations in the
    backward instead of keeping them) is read by the training forward.
    The JAX package's TPU and mesh levers (``opt_*``, ``unroll_layers``,
    ``use_pallas``) have no counterpart: the kernel wrappers decide by the
    tensors' device."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None   # default d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None   # sliding-window attention (h2o-danube)
    rope_theta: float = 10000.0
    use_rope: bool = True
    rotary_pct: float = 1.0
    causal: bool = True
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    mlp: str = "swiglu"            # swiglu | gelu | relu2
    tie_embeddings: bool = False
    # MoE (granite, deepseek)
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_dense_ff: Optional[int] = None   # deepseek: layer 0 is dense
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # hybrid (zamba2): a SHARED attention block applied every k ssm layers
    attn_every: int = 0
    rwkv_head_dim: int = 64        # ssm (RWKV6) head size
    enc_layers: int = 0            # encdec (Whisper): encoder layers
    dec_layers: int = 0            # encdec (Whisper): decoder layers
    n_patches: int = 0             # vlm (internvl): patch embeddings before the text
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"        # activation dtype
    remat: bool = True             # training: recompute each layer in the backward

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def scaled(self, **overrides) -> "ArchConfig":
        """A copy with some fields replaced (reduced sizes for tests)."""
        return dataclasses.replace(self, **overrides)


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Partition rules (the JAX package's, with a tuple for its PartitionSpec)
# ---------------------------------------------------------------------------
# One (pod, data, model) vocabulary: parameters follow Megatron-style tensor
# parallelism over ``model``, the batch shards over ``pod`` x ``data``, and
# the optimizer state also over ``data`` (ZeRO-1).  A spec is a tuple with
# one entry a dim: None (not split), an axis name, or a tuple of names.

POD, DATA, MODEL = "pod", "data", "model"
#: the batch shards over every data-parallel axis the mesh has
BATCH_AXES = (POD, DATA)

#: a decode cache's slot axis: the batch's axes, then ``model`` (the slot
#: strips of ``repro_torch.processes.lm.DecodeStep``, a lane's own slots)
SLOT_AXES = BATCH_AXES + (MODEL,)

#: (path regex, spec) pairs; the first match wins
Rules = List[Tuple[str, Tuple]]


def spec_for(path: str, rules: Rules) -> Tuple:
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return ()  # replicate by default (norms, biases, small tables)


def tree_paths(tree: Any) -> Dict[str, Any]:
    """``{keystr path: leaf}`` in the tree's flatten order."""
    return dict(tree_flatten(tree))


def partition_tree(tree: Any, rules: Rules) -> Any:
    """The spec tree matching ``tree`` by the rule table (a leaf's spec
    may not be longer than its rank)."""
    specs = []
    for name, leaf in tree_flatten(tree):
        spec = spec_for(name, rules)
        if len(spec) > len(tuple(leaf.shape)):
            raise ValueError(f"{name}: spec {spec} too long for shape {tuple(leaf.shape)}")
        specs.append((name, spec))
    return tree_unflatten(specs)


def zero1_spec(spec: Tuple, shape: Tuple[int, ...], data_axis: str = DATA) -> Tuple:
    """ZeRO-1 sharding of an optimizer-state leaf: the parameter's spec
    with ``data`` on its first unsplit dim that 16 divides."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, s) in enumerate(zip(entries, shape)):
        if e is None and s % 16 == 0:  # divisibility by the data axis size
            entries[i] = data_axis
            return tuple(entries)
    return tuple(entries)


# ---------------------------------------------------------------------------
# Parameter init (random weights from a seeded torch.Generator; the JAX
# package's jax.random draws are not reproduced: tests carry the JAX
# parameters across with repro_torch.interop.params_from_reference)
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, t: torch.Tensor, fan_in: int) -> torch.Tensor:
    """Fill ``t`` in place with N(0, fan_in^-1/2) projection weights.
    Sampled straight into ``t``: no float32 copy of a large leaf."""
    return t.normal_(0.0, float(fan_in) ** -0.5, generator=generator)


def embed_init(generator: torch.Generator, t: torch.Tensor) -> torch.Tensor:
    """Fill ``t`` in place with N(0, 0.02) embedding rows."""
    return t.normal_(0.0, 0.02, generator=generator)


#: the parameter subtrees stacked with leading layer axes, and how many:
#: (L,), or Zamba2's (n_super, per_super) Mamba2 stack
STACKED = {"['layers']": 1, "['enc_layers']": 1, "['dec_layers']": 1, "['mamba_layers']": 2}


def init_leaf_(name: str, t: torch.Tensor, generator: torch.Generator) -> None:
    """Fill one parameter in place by its role, as the JAX package's
    ``init_*`` functions do: norm scales and Mamba2's skip ``D`` 1, biases,
    the RWKV6 token-shift mixes and decay base and Mamba2's ``A_log`` and
    ``dt_bias`` 0, embedding rows and Whisper's learned decoder positions
    :func:`embed_init`, projections :func:`dense_init`.  A projection's
    fan-in is the first axis of its per-layer shape (the JAX
    ``dense_init``'s ``shape[0]``), so RWKV6's (5, 32, d) ``tm_w2`` has
    fan-in 5 and Mamba2's (ssm_conv, channels) ``conv_w`` ``ssm_conv``."""
    leaf = name.rsplit("[", 1)[-1].strip("[]'")
    with torch.no_grad():
        if leaf in ("scale", "gn_scale", "norm_scale", "D"):
            t.fill_(1.0)
        elif (leaf in ("bias", "gn_bias", "decay", "conv_b", "A_log", "dt_bias")
              or leaf.startswith(("b_", "maa_"))):
            t.zero_()
        elif leaf in ("embedding", "pos_dec"):
            embed_init(generator, t)
        else:
            per_layer = t.shape[STACKED.get(name[:name.index("]") + 1], 0):]
            dense_init(generator, t, per_layer[0])


def unstacked(tree: Any, n: int) -> list:
    """A stacked ``(n, ...)`` parameter tree as ``n`` trees, one ``unbind``
    a leaf: its backward stacks the parts' gradients into one tensor (a view
    a layer would zero-fill a full-size gradient per layer)."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda p, i=i: p[i], parts) for i in range(n)]


def remat_call(remat: bool, fn: Callable[..., Any], *args: Any) -> Any:
    """``fn(*args)``, under non-reentrant ``torch.utils.checkpoint`` when
    ``remat`` (its activations recomputed in the backward), as the
    reference wraps a layer's scan body in ``jax.checkpoint``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def stacked(specs: Any, n_layers: int) -> Any:
    """Per-layer specs with a leading (L,) layer axis (the JAX package's
    ``vmap``-ed layer init and ``scan`` layout)."""
    return tree_map(lambda s: type(s)((n_layers,) + tuple(s.shape), s.dtype), specs)


def alloc_tree(specs: Any, device=None) -> Any:
    """Uninitialised tensors laid out as a tree of :class:`TensorSpec`."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype), device=device),
                    specs)


def init_tree(specs: Any, generator: torch.Generator, *, device=None,
              out: Optional[Any] = None) -> Any:
    """Random parameters for a model's ``param_specs()`` drawn from
    ``generator`` (on ``device``, the generator's device), each leaf by its
    role (:func:`init_leaf_`).  ``out``, a tree laid out as ``specs`` (e.g.
    the weights arena's views), is filled in place and returned, so
    full-size weights are made on the card with no second copy."""
    if out is None:
        out = alloc_tree(specs, device)
    for name, t in tree_flatten(out):
        init_leaf_(name, t, generator)
    return out
