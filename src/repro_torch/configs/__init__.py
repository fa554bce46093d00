"""Configurations the port runs: the paper's MRI case study
(:mod:`.mri_recon`) and the LM architectures of every family: dense, moe
(MoE and MLA), ssm (RWKV6), hybrid (Zamba2), encdec (Whisper) and vlm
(``get_config`` / ``get_smoke`` by arch id, as ``repro.configs``).

Each LM module defines ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests), copied from the JAX
package's module of the same name.  ``SHAPES`` is the assigned set of input
shapes, and ``cells()`` the (arch x shape) grid of the dry run with its
skips, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.models.common import ArchConfig

#: the architectures the port runs, in the JAX package's order
ARCH_IDS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b", "qwen3-14b", "minitron-8b",
            "h2o-danube-1.8b", "qwen2-7b", "zamba2-2.7b", "rwkv6-3b", "whisper-large-v3",
            "internvl2-2b"]


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; the port has {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def is_subquadratic(cfg: ArchConfig) -> bool:
    """long_500k applicability: SSM / hybrid / sliding-window archs."""
    return cfg.family in ("ssm", "hybrid") or cfg.window is not None


def shape_applicable(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not is_subquadratic(cfg):
        return False, "full quadratic attention at 524k context (DESIGN.md §Arch-applicability)"
    return True, ""


def cells(include_skips: bool = False) -> List[Tuple[str, str, bool, str]]:
    """All 40 (arch, shape) cells with applicability flags."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES:
            ok, why = shape_applicable(cfg, s)
            if ok or include_skips:
                out.append((a, s, ok, why))
    return out
