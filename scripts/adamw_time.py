"""The device time of one eager AdamW step at h2o-danube-1.8b's full width,
on the card, between CUDA events: an independent reading of what the
training step's ``train.optimizer`` span times inside its graph (the
clip's global norm, AdamW and the parameter cast).

    PYTHONPATH=src python3 scripts/adamw_time.py

The parameters are h2o-danube-1.8b's full-width leaves in bf16, N(0,
0.02²), with a bf16 gradient of the same shapes and the f32 master and
moments of ``adamw_init``; AdamW as the ``danube.train`` benchmark cell
runs it (b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1, clip 1.0, a
constant lr of 1e-5).  One warm-up step, then seven steps, each between
two events on the current stream.  The bound is the step's bytes at the
card's data-sheet bandwidth, from the kernels' cost models: each leaf's
update (28 bytes a bf16 parameter) and the clip's read of the gradient
(2 bytes): 16.40 ms for the 1,831,201,280 parameters on an H100 SXM.  The
last line is one JSON object: each step's ms, their median, the bound and
the median's share of it, the card's name and power limit.

``chip_smoke.py`` builds its AdamW step with :func:`danube_state`,
:data:`CFG`, :func:`bound_ms` and :func:`step_ms` too.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.core.arena import tree_flatten, tree_unflatten
from repro_torch.launch.roofline import card_peaks, roofline_terms
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, Schedule, adamw_init, adamw_update

ARCH = "h2o-danube-1.8b"
STEPS = 7
CFG = AdamWConfig(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0,
                  schedule=Schedule(kind="constant", base_lr=1e-5, warmup_steps=0))


def danube_state(dev) -> tuple:
    """(params, grads, state): the full-width bf16 leaves, a bf16 gradient
    of the same shapes and ``adamw_init``'s state, made on ``dev`` from a
    fixed seed."""
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = tree_flatten(build_model(get_config(ARCH)).param_specs())

    def leaves(std):
        return tree_unflatten((n, torch.empty(tuple(s.shape), dtype=torch.bfloat16, device=dev)
                               .normal_(0.0, std, generator=gen)) for n, s in specs)
    params, grads = leaves(0.02), leaves(1e-4)
    return params, grads, adamw_init(params)


def bound_ms(params, grads, state, peaks: dict) -> float:
    """The step's bytes at ``peaks``: each leaf's update and the norm's read
    of the gradient, by the kernels' cost models."""
    flat = [dict(tree_flatten(t)) for t in (params, state["master"], grads, state["m"],
                                            state["v"])]
    return 1e3 * (sum(max(roofline_terms("adamw_update", *(t[n] for t in flat), peaks=peaks))
                      for n in flat[0])
                  + max(roofline_terms("sum_squares", list(flat[2].values()), peaks=peaks)))


def step_ms(step) -> list:
    """Device ms of ``step()``: one warm-up call, then :data:`STEPS` calls,
    each between two events on the current stream."""
    step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return ms


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("adamw_time.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    params, grads, state = danube_state(dev)
    bound = bound_ms(params, grads, state, card_peaks(torch.cuda.get_device_name(dev)))
    ms = step_ms(lambda: adamw_update(params, grads, state, CFG))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    median = statistics.median(ms)
    out = {"arch": ARCH, "elements": sum(math.prod(p.shape) for _, p in tree_flatten(params)),
           "ms": ms, "median_ms": median, "bound_ms": bound, "bound_share": bound / median,
           "card": smi}
    print(f"AdamW step at {ARCH}'s full width: median {median:.3f} ms, bound {bound:.3f} ms "
          f"(bytes), {100 * bound / median:.1f} % of the bound's speed")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
