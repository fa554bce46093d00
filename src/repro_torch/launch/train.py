"""Training driver of the port, the counterpart of ``repro.launch.train``
(the same flags):

    python -m repro_torch.launch.train --arch h2o-danube-1.8b --scale full \\
        [--steps 6] [--batch 4] [--seq 2048] [--ckpt-dir DIR] [--compress-grads] [--cpu]
        [--multi-pod]
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
reference's do).  ``--multi-pod`` trains on the reference's multi-pod
production mesh, (pod 2, data 16, model 16) over 512 cards
(``make_production_mesh``, which refuses fewer cards, naming both
counts): every family data parallel over ``pod`` and ``data`` and tensor
parallel over ``model`` (a config whose dimensions the axes do not divide
is refused by ``check_train_mesh``, naming the leaf).
"""
from __future__ import annotations

import argparse
import math
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.arena import torch_dtype
from repro_torch.data.pipeline import StreamConfig, TokenStream
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.common import ArchConfig, tree_flatten
from repro_torch.optim import AdamWConfig, Schedule
from repro_torch.train import TrainConfig, Trainer, TrainerConfig

def train_state_bytes(cfg: ArchConfig, lanes: int = 1, microbatches: int = 1) -> int:
    """Bytes of a train state of ``cfg`` on the device at the step's peak,
    from its parameter specs (nothing allocated): a parameter replica a
    data lane on the one device (``lanes``), one lane's gradients in the
    parameter dtype (the lanes and microbatches take turns), the f32
    master, m and v (whole, or in the lanes' ZeRO-1 pieces), and the f32
    sum of the parts' gradients where there are several parts."""
    total = 0
    for _, spec in tree_flatten(build_model(cfg).param_specs()):
        n = math.prod(spec.shape)
        total += n * ((lanes + 1) * torch_dtype(spec.dtype).itemsize + 12
                      + (4 if lanes * microbatches > 1 else 0))
    return total


def mesh_state_bytes(model, mesh, compress: bool = False) -> list:
    """(parameter bytes, optimizer bytes) that each grid position of
    ``mesh`` holds of ``model``'s placed train state (its pieces by
    ``state_pspecs``: parameters by the partition rules, master, m, v, the
    step counter and ``ef`` in their ZeRO-1 pieces), from the specs with
    nothing allocated."""
    from repro_torch.launch.mesh import piece_index
    from repro_torch.train.step import state_pspecs, to_named, train_state_specs
    like = train_state_specs(model, compress)
    places = dict(tree_flatten(to_named(state_pspecs(model, like), mesh)))
    out = [[0, 0] for _ in range(mesh.devices.size)]
    for name, spec in tree_flatten(like):
        size = torch_dtype(spec.dtype).itemsize
        for k in range(mesh.devices.size):
            index = piece_index(spec.shape, places[name].spec, mesh, k)
            out[k][0 if name.startswith("['params']") else 1] += \
                size * math.prod(b - a for a, b in index)
    return [tuple(b) for b in out]


def check_fits(cfg: ArchConfig, device: torch.device, lanes: int = 1,
               microbatches: int = 1) -> None:
    """Refuse a config whose train state (of ``lanes`` data lanes on the
    one device) exceeds the card's memory."""
    if device.type != "cuda":
        return
    need = train_state_bytes(cfg, lanes, microbatches)
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
    model = build_model(cfg)
    mesh = None
    if args.multi_pod:
        mesh = make_production_mesh(multi_pod=True)
    device = torch.device("cpu") if args.cpu else torch.device("cuda")
    if mesh is None:
        check_fits(cfg, device, microbatches=args.microbatches)

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
    trainer = Trainer(model, tcfg, mesh=mesh, device=device)
    trainer.fit_with_restarts(stream, args.seed)
    first = trainer.history[0][1] if trainer.history else float("nan")
    last = trainer.history[-1][1] if trainer.history else float("nan")
    where = f"the mesh {mesh.shape}" if mesh is not None else device
    print(f"[train] {args.arch} ({args.scale}) {args.steps} steps on {where}: "
          f"loss {first:.4f} -> {last:.4f}")
    return trainer


if __name__ == "__main__":
    main()
