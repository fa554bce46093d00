"""The device time of one eager AdamW step at a model's full width, on the
card, between CUDA events: an independent reading of what the training
step's ``train.optimizer`` span times inside its graph (the clip's global
norm, AdamW and the parameter cast).

    PYTHONPATH=src python3 scripts/adamw_time.py

The parameters are h2o-danube-1.8b's full-width leaves in bf16, N(0,
0.02²), with a bf16 gradient of the same shapes and the f32 master and
moments of ``adamw_init``; AdamW as the ``danube.train`` benchmark cell
runs it (b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1, clip 1.0, a
constant lr of 1e-5).  One warm-up step, then seven steps, each
between two events on the current stream.  The last line is one JSON
object: each step's ms, their median, the card's name and power limit.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.core.arena import tree_flatten, tree_unflatten
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, Schedule, adamw_init, adamw_update

ARCH = "h2o-danube-1.8b"
STEPS = 7


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("adamw_time.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = tree_flatten(build_model(get_config(ARCH)).param_specs())

    def leaves(std):
        return tree_unflatten((n, torch.empty(tuple(s.shape), dtype=torch.bfloat16, device=dev)
                               .normal_(0.0, std, generator=gen)) for n, s in specs)
    params, grads = leaves(0.02), leaves(1e-4)
    state = adamw_init(params)
    cfg = AdamWConfig(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0,
                      schedule=Schedule(kind="constant", base_lr=1e-5, warmup_steps=0))
    adamw_update(params, grads, state, cfg)
    torch.cuda.synchronize(dev)
    ms = []
    for _ in range(STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        adamw_update(params, grads, state, cfg)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"arch": ARCH, "elements": sum(math.prod(s.shape) for _, s in specs), "ms": ms,
           "median_ms": statistics.median(ms), "card": smi}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
