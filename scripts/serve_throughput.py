#!/usr/bin/env python3
"""``LMServer`` throughput at full width on one CUDA card, in a fresh process.

    PYTHONPATH=src python3 scripts/serve_throughput.py [--arch A]

Builds ``--arch`` (qwen3-14b by default, rwkv6-3b or whisper-large-v3) at
full width with random bf16 weights made on the card from seed 0, and
serves the requests of ``chip_smoke.py``'s ``[lm]`` phase through
``LMServer(batch=4)``: 10 prompts of 17-1024 tokens (max_len 2048), or for
whisper 4-224 tokens with 1500 frames each (max_len 448), 32 new tokens
each.  Prints tokens/s of ``run()``, the prefill mean and the decode p50
from the server's profiles, and the peak device memory, beside the card's
name and power limit.

It uses only what every slice of the port since the whisper one has, and
imports whichever ``repro_torch`` comes first on ``PYTHONPATH``, so one
call can time two trees in turn: ``PYTHONPATH=<tree>/src python3
scripts/serve_throughput.py --arch rwkv6-3b``.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="serve_throughput.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-14b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_throughput.py: no CUDA device")
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.core import CLapp
    from repro_torch.models import build_model
    from repro_torch.processes.lm import weights_data
    from repro_torch.serve import LMServer, SamplingConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_config(args.arch)
    model = build_model(cfg)
    app = CLapp().init()
    weights, wcodec = weights_data(model.param_specs())
    app.addData(weights)
    model.init_params(torch.Generator(device=app.device).manual_seed(0),
                      out=wcodec.unflatten(weights.device_views()))
    enc_len = 1500 if cfg.family == "encdec" else None
    (lo, hi), max_len = ((4, 225), 448) if enc_len else ((17, 1025), 2048)
    server = LMServer(model, weights, batch=4, max_len=max_len, enc_len=enc_len,
                      sampling=SamplingConfig(max_new_tokens=32), app=app)
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(lo, hi, size=10)]
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lengths]
    frames = [rng.standard_normal((enc_len, cfg.d_model), dtype=np.float32)
              if enc_len else None for _ in lengths]
    for prompt, fr in zip(prompts, frames):
        server.submit(prompt, frames=fr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = server.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    tokens = sum(len(r) for r in results)
    print(f"[serve_throughput] {smi}; repro_torch from {repro_torch.__file__}: {args.arch}, "
          f"{len(lengths)} requests, 4 slots: {tokens} tokens in {run_s:.3f} s = "
          f"{tokens / run_s:.2f} tokens/s; prefill mean "
          f"{statistics.mean(server.prefill_profile.samples) * 1e3:.2f} ms, decode p50 "
          f"{statistics.median(server.decode_profile.samples) * 1e3:.3f} ms over "
          f"{server.steps} steps; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


if __name__ == "__main__":
    main()
