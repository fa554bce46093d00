"""Sampling configuration of the serving layer (``repro/serve/engine.py``'s
``SamplingConfig``; the ``ServeEngine`` compatibility shim is a later
slice of the port)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SamplingConfig:
    temperature: float = 0.0      # 0 = greedy
    top_k: int = 0                # 0 = no top-k
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
