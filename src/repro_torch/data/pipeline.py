"""Training data pipeline, mirroring ``repro/data/pipeline.py`` (numpy, so
every batch is the reference's byte for byte).

Each data-parallel host owns a deterministic shard of an (infinite,
seeded) token stream, ``TokenStream(shard_id, n_shards)``: a seeded
Zipf-ish mixture, a pure function of (seed, shard, step), so a restart
replays exactly the same sequence, which the fault-tolerance tests rely
on.  A file-backed corpus (tokens in an ``.npz`` read through
:mod:`repro_torch.data.io`) plugs in through the same interface.

:class:`ArenaFeed` packs each step's batch into ONE arena host blob (the
single-call transfer unit) for the streaming executor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class StreamConfig:
    vocab: int
    seq: int
    batch: int                 # per-shard batch
    seed: int = 0
    kind: str = "lm"           # lm | vlm | encdec
    n_patches: int = 0         # vlm
    d_model: int = 0           # vlm/encdec stub embedding width
    enc_frames: int = 0        # encdec


class TokenStream:
    """Deterministic, restartable synthetic token stream."""

    def __init__(self, cfg: StreamConfig, shard_id: int = 0, n_shards: int = 1):
        self.cfg = cfg
        self.shard_id = shard_id
        self.n_shards = n_shards

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + self.shard_id) * 1_000_003 + step)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch for a given global step (pure function of step)."""
        cfg = self.cfg
        rng = self._rng(step)
        # zipf-flavoured token draw bounded to vocab
        toks = rng.zipf(1.3, size=(cfg.batch, cfg.seq + 1)).astype(np.int64)
        toks = (toks - 1) % cfg.vocab
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if cfg.kind == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (cfg.batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
        if cfg.kind == "encdec":
            batch["frames"] = rng.standard_normal(
                (cfg.batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ArenaFeed:
    """Adapt a step-indexed loader (``TokenStream`` / ``FileCorpus``: any
    object with ``batch_at(step) -> {name: np.ndarray}``) to the streaming
    executor: iterating yields one packed arena host blob a step, and
    ``self.layout`` is the shared :class:`~repro_torch.core.arena.
    ArenaLayout` (a loader's steps are shape-homogeneous, so the layout is
    planned once from the first batch)."""

    def __init__(self, source, steps: int, start: int = 0):
        from repro_torch.core.arena import plan_layout

        self.source = source
        self.steps = int(steps)
        self.start = int(start)
        first = source.batch_at(self.start)
        self.layout = plan_layout(
            (name, np.asarray(a).shape, np.asarray(a).dtype) for name, a in first.items())

    def __iter__(self) -> Iterator[np.ndarray]:
        from repro_torch.core.arena import pack_host

        for step in range(self.start, self.start + self.steps):
            blob, _ = pack_host(self.source.batch_at(step), self.layout)
            yield blob

    def data_at(self, step: int):
        """The same step as a registrable :class:`repro_torch.core.data.Data`."""
        from repro_torch.core.data import Data

        return Data(self.source.batch_at(step))


class FileCorpus:
    """Token corpus stored as npz arrays {'tokens': (N,) int32}; serves
    fixed-length windows, sharded round-robin over hosts."""

    def __init__(self, path: str, seq: int, batch: int, shard_id: int = 0, n_shards: int = 1):
        from . import io as repro_io
        self.tokens = repro_io.load_any(path)["tokens"].astype(np.int32)
        self.seq, self.batch = seq, batch
        self.shard_id, self.n_shards = shard_id, n_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        n = len(self.tokens) - self.seq - 1
        idx0 = (step * self.n_shards + self.shard_id) * self.batch
        rows = []
        for b in range(self.batch):
            off = ((idx0 + b) * self.seq) % max(1, n)
            rows.append(self.tokens[off: off + self.seq + 1])
        toks = np.stack(rows)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
