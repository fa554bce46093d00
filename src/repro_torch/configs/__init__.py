"""Configurations the port runs: the paper's MRI case study
(:mod:`.mri_recon`) and the LM architectures of every family: dense, moe
(MoE and MLA), ssm (RWKV6), hybrid (Zamba2), encdec (Whisper) and vlm
(``get_config`` / ``get_smoke`` by arch id, as ``repro.configs``).

Each LM module defines ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests), copied from the JAX
package's module of the same name.
"""
from __future__ import annotations

import importlib

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
