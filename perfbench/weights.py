"""The weights of a decoder configuration, made by the benchmark from the
seed, which both the program and the plain reference are given.

The layout is the dense decoder's parameter tree (stacked ``(L, ...)``
layer leaves, key paths as ``[...]['...']`` strings in sorted order), laid
out here from the configuration file alone.  Every matrix is drawn from
N(0, ``init_std``), every norm scale is 1.  All values come from one
``torch.randn`` call on the device, so the same seed gives the same
weights on any run, in the program and in the reference alike.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def param_shapes(arch: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """``[(key path, shape)]`` of a dense decoder's parameters, in the
    sorted order of its tree."""
    d, h, kv, dh, f, v, n = (arch[k] for k in ("d_model", "n_heads", "n_kv_heads", "d_head",
                                               "d_ff", "vocab", "n_layers"))
    tree = {
        "embed": {"embedding": (v, d), "unembed": (d, v)},
        "final_norm": {"scale": (d,)},
        "layers": {
            "attn": {"w_q": (n, d, h * dh), "w_k": (n, d, kv * dh), "w_v": (n, d, kv * dh),
                     "w_o": (n, h * dh, d)},
            "ln_attn": {"scale": (n, d)},
            "ln_mlp": {"scale": (n, d)},
            "mlp": {"w_down": (n, f, d), "w_gate": (n, d, f), "w_up": (n, d, f)},
        },
    }

    def walk(node, prefix):
        out = []
        for k in sorted(node):
            if isinstance(node[k], dict):
                out += walk(node[k], f"{prefix}[{k!r}]")
            else:
                out.append((f"{prefix}[{k!r}]", tuple(node[k])))
        return out
    return walk(tree, "")


def is_norm(name: str) -> bool:
    return name.endswith("['scale']")


def make_flat(arch: Dict, seed: int, device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(one flat bf16 buffer, ``{key path: view}``) of the weights of
    ``seed``: N(0, 0.02^2), norm scales 1."""
    shapes = param_shapes(arch)
    total = sum(_numel(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.bfloat16)
    flat.mul_(0.02)
    views, off = {}, 0
    for name, shape in shapes:
        n = _numel(shape)
        views[name] = flat[off:off + n].view(shape)
        if is_norm(name):
            views[name].fill_(1.0)
        off += n
    return flat, views


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def nest(flat_views: Dict[str, torch.Tensor]) -> Dict:
    """The nested dict of ``{key path: leaf}``."""
    out: Dict = {}
    for path, leaf in flat_views.items():
        keys = [k.strip("'") for k in path.strip("[]").split("][")]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out
