"""Training driver of the port, the counterpart of ``repro.launch.train``
(the same flags):

    python -m repro_torch.launch.train --arch h2o-danube-1.8b --scale full \\
        [--steps 6] [--batch 4] [--seq 2048] [--ckpt-dir DIR] [--compress-grads] [--cpu]
    (with src/ on PYTHONPATH)

Runs on the CUDA card (each step one replay of the captured step);
``--cpu`` asks for the CPU.  ``--scale smoke`` trains the reduced
same-family config; ``--scale full`` the published one on the one card,
after checking, before anything is allocated, that its train state
(parameters, f32 master, m and v, gradients) fits the card's memory: a
config that does not is refused with both sizes (qwen3-14b needs about
237 GB), not cut down.  Every family trains: the decoder family (dense,
moe, vlm), rwkv6-3b (ssm), zamba2-2.7b (hybrid) and whisper-large-v3
(encdec: its batches carry ``max(8, seq // 2)`` frames a sample, as the
reference's do); ``--multi-pod`` (a production mesh) waits for the
multi-GPU slice.
"""
from __future__ import annotations

import argparse
import math
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.arena import torch_dtype
from repro_torch.data.pipeline import StreamConfig, TokenStream
from repro_torch.models import build_model
from repro_torch.models.common import ArchConfig, tree_flatten
from repro_torch.optim import AdamWConfig, Schedule
from repro_torch.train import TrainConfig, Trainer, TrainerConfig

def train_state_bytes(cfg: ArchConfig) -> int:
    """Bytes of a train state of ``cfg`` on the device, from its parameter
    specs (nothing allocated): the parameters and their gradients in the
    parameter dtype, the f32 master, m and v."""
    total = 0
    for _, spec in tree_flatten(build_model(cfg).param_specs()):
        n = math.prod(spec.shape)
        total += n * (2 * torch_dtype(spec.dtype).itemsize + 12)
    return total


def check_fits(cfg: ArchConfig, device: torch.device) -> None:
    """Refuse a config whose train state exceeds the card's memory."""
    if device.type != "cuda":
        return
    need = train_state_bytes(cfg)
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        raise RuntimeError(
            f"{cfg.name}: its train state needs {need / 1e9:.1f} GB (parameters and gradients "
            f"in {cfg.param_dtype}, f32 master, m and v); {torch.cuda.get_device_name(device)} "
            f"has {have / 1e9:.1f} GB")


def main(argv: Optional[list] = None) -> Trainer:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of the card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.scale == "full" else get_smoke(args.arch)
    if args.multi_pod:
        raise NotImplementedError("--multi-pod: a production mesh waits for the multi-GPU "
                                  "slice (ROADMAP.md queue 1, item 6)")
    device = torch.device("cpu") if args.cpu else torch.device("cuda")
    check_fits(cfg, device)
    model = build_model(cfg)

    kind = {"encdec": "encdec", "vlm": "vlm"}.get(cfg.family, "lm")
    seq = args.seq - (cfg.n_patches if kind == "vlm" else 0)
    stream = TokenStream(StreamConfig(
        vocab=cfg.vocab, seq=seq, batch=args.batch, seed=args.seed, kind=kind,
        n_patches=cfg.n_patches, d_model=cfg.d_model, enc_frames=max(8, args.seq // 2)))
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_interval=args.ckpt_interval,
        log_every=args.log_every,
        train=TrainConfig(
            microbatches=args.microbatches, compress_grads=args.compress_grads,
            opt=AdamWConfig(schedule=Schedule(
                base_lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                total_steps=args.steps))))
    trainer = Trainer(model, tcfg, device=device)
    trainer.fit_with_restarts(stream, args.seed)
    first = trainer.history[0][1] if trainer.history else float("nan")
    last = trainer.history[-1][1] if trainer.history else float("nan")
    print(f"[train] {args.arch} ({args.scale}) {args.steps} steps on {device}: "
          f"loss {first:.4f} -> {last:.4f}")
    return trainer


if __name__ == "__main__":
    main()
