"""Serving example of the port: continuous-batching decode through the
Pipeline stack (the ``serve_transformer`` and ``serve_whisper`` parts of the
JAX package's ``examples/serve_lm.py``, at the SMOKE sizes).

    python -m repro_torch.launch.serve_lm [--cpu] [--arch A]
    (with src/ on PYTHONPATH)

Runs on the CUDA card; ``--cpu`` asks for the CPU.  Random weights come
from a seeded ``torch.Generator``, nothing is trained or downloaded.

* ``--arch`` SMOKE (qwen3-14b by default; any decoder-only architecture
  of ``repro_torch.configs.ARCH_IDS``, e.g. minitron-8b,
  granite-moe-1b-a400m, deepseek-v2-lite-16b, the hybrid zamba2-2.7b or
  internvl2-2b, text-only): 10 requests of 3-9
  prompt tokens through 4 slots of :class:`~repro_torch.serve.LMServer`,
  16 new tokens each.  The decode state is one persistent arena Data on
  the device: the decode side records no host-to-device transfer
  (checked).
* whisper-large-v3 SMOKE: 4 requests through 2 slots, each a 3-token
  prompt with its own audio frames (16 encoder positions, the stubbed
  front end's embeddings), 8 new tokens each (checked).  A request's
  prefill pipe joins its prompt and frames (two input edges), encodes the
  frames and writes the cross K/V into the slot.

The JAX example's third part, ``serve_front_door`` (two replicas behind
the control plane), waits for the port's control plane (ROADMAP queue 1,
item 7).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.core import CLapp, DeviceTraits, DeviceType
from repro_torch.models import build_model
from repro_torch.serve import LMServer, SamplingConfig


def _params(model, app: CLapp, seed: int):
    return model.init_params(torch.Generator(device=app.device).manual_seed(seed),
                             device=app.device)


def serve_transformer(app: CLapp, arch: str = "qwen3-14b") -> List[List[int]]:
    cfg = get_smoke(arch)
    model = build_model(cfg)
    server = LMServer(model, _params(model, app, 0), batch=4, max_len=64,
                      sampling=SamplingConfig(max_new_tokens=16), app=app)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab, size=rng.integers(3, 10))) for _ in range(10)]
    for p in prompts:
        server.submit(p)
    t0 = time.perf_counter()
    outputs = server.run()
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outputs)
    print(f"[{arch}] served {len(prompts)} requests through 4 slots on {app.device}: "
          f"{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s)")
    for i, o in enumerate(outputs[:4]):
        print(f"  request {i}: {len(o)} tokens -> {o[:8]}...")
    if not all(len(o) == 16 for o in outputs):
        raise RuntimeError(f"{arch}: requests got {[len(o) for o in outputs]} tokens, not 16")
    transfer = server.decode_profile.phase_total("transfer")
    print(f"  decode-side host2device on the cache edge: {transfer:.6f}s "
          f"over {server.steps} steps")
    if transfer != 0.0:
        raise RuntimeError(f"{arch}: the decode side moved data host to device ({transfer} s)")
    return outputs


def serve_whisper(app: CLapp) -> List[List[int]]:
    cfg = get_smoke("whisper-large-v3")
    model = build_model(cfg)
    enc_len = 16
    server = LMServer(model, _params(model, app, 1), batch=2, max_len=32, enc_len=enc_len,
                      sampling=SamplingConfig(max_new_tokens=8), app=app)
    rng = np.random.default_rng(1)
    for _ in range(4):
        prompt = list(rng.integers(0, cfg.vocab, size=3))
        frames = rng.standard_normal((enc_len, cfg.d_model)).astype(np.float32)
        server.submit(prompt, frames=frames)
    outputs = server.run()
    print(f"[whisper] served {len(outputs)} audio requests on {app.device} (one prefill "
          f"process a request: its frames encoded, its cross K/V cached): "
          f"{[len(o) for o in outputs]} tokens each")
    if not all(len(o) == 8 for o in outputs):
        raise RuntimeError(f"whisper: requests got {[len(o) for o in outputs]} tokens, not 8")
    return outputs


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--arch", default="qwen3-14b", help="the decoder-only architecture served",
                    choices=[a for a in ARCH_IDS if get_smoke(a).family != "encdec"])
    args = ap.parse_args(argv)
    traits = DeviceTraits(type=DeviceType.CPU) if args.cpu else DeviceTraits()
    app = CLapp().init(device_traits=traits)
    out = {args.arch: serve_transformer(app, args.arch), "whisper": serve_whisper(app)}
    print("all requests completed")
    return out


if __name__ == "__main__":
    main()
