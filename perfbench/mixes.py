"""The traffic generator.  A mix is a data file,
``perfbench/traffic/<name>.json``: the name of the driver that runs it and
the parameters it reads (stack counts, batch and sequence sizes, the
optimizer).  This module finds a mix by name and turns a seed into the
rows that a training mix feeds.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load_mix(name: str) -> Dict:
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r}: {path} is missing")
    return json.loads(path.read_text())


def train_batch(seed: int, step: int, batch: int, seq: int, vocab: int) -> Dict[str, np.ndarray]:
    """Step ``step``'s rows: ``tokens`` and next-token ``labels`` (B, S)
    int32, uniform over the vocabulary; no two steps share a row."""
    rng = np.random.default_rng([int(seed), 11, step])
    ids = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64).astype(np.int32)
    return {"tokens": np.ascontiguousarray(ids[:, :-1]), "labels": np.ascontiguousarray(ids[:, 1:])}
