#!/usr/bin/env python3
"""Where the time of the port's LM serving path goes, on one CUDA card.

    python3 src/repro_torch/launch/lm_step_profile.py [--arch A] [--layers N] [--batch B]
                                                      [--prompt S]

Builds ``--arch`` (qwen3-14b by default, or rwkv6-3b) at full width
(``--layers`` cuts only the depth; random bf16 weights made on the card
from seed 0), prefills a batch of ``--batch``
prompts of ``--prompt`` tokens through ``DecodeSession``, then traces
decode steps and one single-prompt prefill with ``torch.profiler``.  For
each it prints the host wall time (ending in a synchronize), the device
busy time (the sum of the CUDA kernels' self time in the trace), the idle
share of the device, and the kernels and host-side operators that take the
most time.  Exits non-zero without a CUDA card, or when the trace holds no
device time.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2]


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--layers", type=int, default=None, help="default: the config's depth")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lm_step_profile: no CUDA card")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.core import CLapp
    from repro_torch.models import build_model
    from repro_torch.processes import DecodeSession, weights_data

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    cfg = get_config(args.arch)
    cfg = cfg.scaled(n_layers=args.layers or cfg.n_layers)
    model = build_model(cfg)
    app = CLapp().init()
    weights, codec = weights_data(model.param_specs())
    app.addData(weights)
    model.init_params(torch.Generator(device=app.device).manual_seed(0),
                      out=codec.unflatten(weights.device_views()))
    sess = DecodeSession(app, model, weights, batch=args.batch, max_len=2048)
    rng = np.random.default_rng(0)
    sess.prefill(rng.integers(0, cfg.vocab, (args.batch, args.prompt)).astype(np.int32))
    for _ in range(3):                       # warm-up: allocator, cuBLAS
        sess.step()

    def traced(label, fn, reps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps * 1e3
        events = prof.key_averages()
        dev = [e for e in events if e.device_type.name == "CUDA"]
        busy = sum(e.self_device_time_total for e in dev) / reps / 1e3
        if busy <= 0:
            sys.exit(f"lm_step_profile: {label}: the trace holds no device time")
        launches = sum(e.count for e in dev) / reps
        print(f"[{label}] {smi}: wall {wall:.3f} ms, device busy {busy:.3f} ms, device idle "
              f"{100 * (1 - busy / wall):.1f} %, {launches:.0f} kernel launches per call")
        for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  device {e.self_device_time_total / reps / 1e3:8.3f} ms  "
                  f"x{e.count / reps:6.0f}  {e.key[:100]}")
        cpu = [e for e in events if e.device_type.name == "CPU"]
        for e in sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:8]:
            print(f"  host   {e.self_cpu_time_total / reps / 1e3:8.3f} ms  "
                  f"x{e.count / reps:6.0f}  {e.key[:100]}")

    traced(f"{cfg.name} decode step, batch {args.batch}, {cfg.n_layers} layers", sess.step,
           args.steps)
    row = DecodeSession(app, model, weights, batch=1, max_len=2048)
    toks = rng.integers(0, cfg.vocab, (1, 1024)).astype(np.int32)
    row.prefill(toks)                        # warm-up of the prefill shapes
    traced(f"{cfg.name} prefill, 1 x 1024 tokens, {cfg.n_layers} layers",
           lambda: row.prefill(toks), 1)


if __name__ == "__main__":
    main()
