"""What the decoder drivers share: the program's model, built from the
configuration file and held to the benchmark's parameter layout."""
from __future__ import annotations

import dataclasses
from typing import Dict

from perfbench import weights


def program_model(config: Dict):
    """The program's model of the configuration file's sizes, and its
    parameter tree's layout, held against the benchmark's."""
    from repro_torch.core.arena import tree_flatten
    from repro_torch.models import build_model
    from repro_torch.models.common import ArchConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    cfg = ArchConfig(**{k: v for k, v in config.items() if k in fields})
    model = build_model(cfg)
    have = [(n, tuple(s.shape)) for n, s in tree_flatten(model.param_specs())]
    want = weights.param_shapes(config)
    if have != want:
        raise RuntimeError(f"the program's parameter layout {have[:3]}... is not the "
                           f"benchmark's {want[:3]}...")
    return model
