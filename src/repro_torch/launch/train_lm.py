"""End-to-end training example of the port, the counterpart of
``examples/train_lm.py``: train a ~100M-parameter LLaMA-style dense LM
(``lm-100m``, f32) for a few hundred steps with the whole stack: the data
stream, the captured train step (the paper's init/launch split at
training scale), asynchronous arena checkpoints and restart-safe resume.

    python -m repro_torch.launch.train_lm [--steps 300] [--tiny] [--ckpt-dir DIR] [--cpu]
    (with src/ on PYTHONPATH)

Runs on the CUDA card; ``--cpu`` asks for the CPU (``--tiny`` shrinks the
model to seconds there).  Without ``--ckpt-dir`` the checkpoints go to a
temporary directory removed at the end.  The loss must improve.
"""
from __future__ import annotations

import argparse
import math
import tempfile
from typing import Optional

import torch

from repro_torch.data.pipeline import StreamConfig, TokenStream
from repro_torch.models import build_model
from repro_torch.models.common import ArchConfig, tree_flatten
from repro_torch.optim import AdamWConfig, Schedule
from repro_torch.train import TrainConfig, Trainer, TrainerConfig


def lm_100m() -> ArchConfig:
    """~106M params: 12L, d=768, 12H (GQA kv=4), ff=2048, vocab=32k."""
    return ArchConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_head=64, d_ff=2048, vocab=32000,
        param_dtype="float32", dtype="float32")


def lm_tiny() -> ArchConfig:
    return ArchConfig(
        name="lm-tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=256, vocab=512,
        param_dtype="float32", dtype="float32")


def trainer_config(steps: int, ckpt_dir: str, ckpt_interval: int = 100) -> TrainerConfig:
    """The example's trainer: cosine schedule to 3e-4 with a 10 % warm-up."""
    return TrainerConfig(
        total_steps=steps, ckpt_dir=ckpt_dir, ckpt_interval=ckpt_interval,
        log_every=max(1, steps // 20),
        train=TrainConfig(opt=AdamWConfig(schedule=Schedule(
            base_lr=3e-4, warmup_steps=steps // 10 + 1, total_steps=steps))))


def main(argv: Optional[list] = None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of the card")
    args = ap.parse_args(argv)

    cfg = lm_tiny() if args.tiny else lm_100m()
    model = build_model(cfg)
    n_params = sum(math.prod(s.shape) for _, s in tree_flatten(model.param_specs()))
    print(f"model: {cfg.name}, {n_params / 1e6:.1f}M params")
    stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=args.seq, batch=args.batch, seed=0))
    device = torch.device("cpu") if args.cpu else torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, trainer_config(args.steps, args.ckpt_dir or tmp),
                          device=device)
        trainer.fit(stream, 0)
    first, last = trainer.history[0][1], trainer.history[-1][1]
    print(f"loss {first:.4f} -> {last:.4f} over {args.steps} steps on {device}")
    if not last < first:
        raise RuntimeError(f"loss must improve: {first:.4f} -> {last:.4f}")
    return trainer


if __name__ == "__main__":
    main()
