"""Per-cell collective attribution: which model op owns the interconnect
(the counterpart of ``repro/launch/diagnose.py``).

    python -m repro_torch.launch.diagnose --arch qwen3-14b --shape train_4k \\
        [--full] [--top 15] [--opt k=v ...]

By default it traces the 2-layer variant of the architecture (the JAX
package's ``c2`` / ``c21`` analysis config), so each layer's collectives
show once; ``--full`` traces the whole model.  It runs on the CPU host on
``meta`` tensors (:mod:`repro_torch.launch.dryrun`) and needs no card.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.dryrun import parse_overrides, run_cell
from repro_torch.launch.roofline import collective_bytes, collective_sources
from repro_torch.models.common import ArchConfig


def two_layers(cfg: ArchConfig) -> ArchConfig:
    """The 2-layer variant of ``cfg``: two Mamba2 superblocks of one layer
    each (hybrid), two encoder layers and one decoder layer (encdec), or
    two stacked layers (after deepseek's dense layer 0)."""
    if cfg.family == "hybrid":
        return cfg.scaled(n_layers=2, attn_every=1)
    if cfg.family == "encdec":
        return cfg.scaled(enc_layers=2, dec_layers=1, n_layers=3)
    return cfg.scaled(n_layers=2 + (1 if cfg.first_dense_ff else 0))


def diagnose(arch: str, shape: str, unrolled: bool = True, top: int = 15, **overrides):
    """Print a card's collective bytes by kind and the ``top`` sources of
    the cell on the production mesh; returns the dry run's record, its
    events under ``"_events"``."""
    cfg = get_config(arch).scaled(**overrides) if overrides else get_config(arch)
    vcfg = two_layers(cfg) if unrolled else cfg
    rec = run_cell(arch, shape, verbose=False, cfg_override=vcfg, microbatches=1)
    events = rec["_events"]
    total = collective_bytes(events)
    print(f"== {arch} x {shape} ({'2-layer' if unrolled else 'full'}) ==")
    print("totals/chip:", {k: f"{v/1e9:.2f}GB" for k, v in total.items()})
    for kind, name, b in collective_sources(events, top):
        print(f"  {b/1e9:8.2f}GB  {kind:20s} {name}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=list(SHAPES), required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--opt", nargs="*", default=[],
                    help="ArchConfig overrides, e.g. remat=0")
    args = ap.parse_args(argv)
    diagnose(args.arch, args.shape, unrolled=not args.full, top=args.top,
             **parse_overrides(args.opt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
