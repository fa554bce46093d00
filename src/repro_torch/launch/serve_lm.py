"""Serving example of the port: continuous-batching decode through the
Pipeline stack, and two servers behind the control plane (the three parts
of the JAX package's ``examples/serve_lm.py``, at the SMOKE sizes).

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

* ``serve_front_door``: two qwen3-14b SMOKE ``LMServer`` replicas, each
  on its own app of the app's device, behind
  :class:`~repro_torch.serve.FrontDoor`
  (``capacity=16``, ``overflow="shed"``, ``policy="least-outstanding"``),
  each a ``CallableReplica(max_batch=2)`` that submits one prompt and runs
  the server: 6 prompts of 5 tokens, every third interactive and the rest
  batch, 8 new tokens each (checked), then the replicas' health and the
  ``frontdoor_requests_completed_total`` lines of the metrics.  On the
  card each replica's worker thread captures its decode step while the
  other replica runs.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.core import CLapp, DeviceTraits, DeviceType
from repro_torch.models import build_model
from repro_torch.serve import CallableReplica, FrontDoor, LMServer, SamplingConfig


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


def serve_front_door(app: CLapp, weights: Any = None) -> Dict[int, List[int]]:
    """Two LMServer replicas behind the FrontDoor control plane; returns
    each request's tokens by its FrontDoor rid.  ``weights`` (a parameter
    tree or weights Data of qwen3-14b SMOKE) defaults to random ones from
    seed 0."""
    cfg = get_smoke("qwen3-14b")
    model = build_model(cfg)

    def make_replica(name: str) -> CallableReplica:
        rapp = CLapp().init(device_traits=traits)          # each replica its own app
        lm = LMServer(model, weights if weights is not None else _params(model, rapp, 0),
                      batch=2, max_len=32, sampling=SamplingConfig(max_new_tokens=8), app=rapp)

        def decode(prompt):
            rid = lm.submit(list(prompt))
            return lm.run()[rid]

        return CallableReplica(name, decode, max_batch=2)

    traits = (DeviceTraits(type=DeviceType.CPU) if app.device.type == "cpu"
              else DeviceTraits(index=app.device.index or 0))
    fd = FrontDoor([make_replica("lm-0"), make_replica("lm-1")],
                   capacity=16, overflow="shed", policy="least-outstanding")
    try:
        rng = np.random.default_rng(2)
        rids = [fd.submit(list(rng.integers(0, cfg.vocab, size=5)),
                          priority="interactive" if i % 3 == 0 else "batch")
                for i in range(6)]
        outcomes = {o.rid: o for o in fd.drain(timeout=600.0)}
        for rid in rids:
            o = outcomes.get(rid)
            if o is None or o.status != "ok" or len(o.result) != 8:
                raise RuntimeError(f"front door: request {rid} ended as {o}")
            print(f"[frontdoor] rid {rid} ({o.priority}) -> {o.replica} on {app.device}: "
                  f"{len(o.result)} tokens in {o.latency_s * 1e3:.0f} ms")
        health = fd.health()
        print(f"[frontdoor] health ok={health['ok']}, served "
              + str({n: r["served"] for n, r in health["replicas"].items()}))
        for line in fd.metrics.render().splitlines():
            if line.startswith("frontdoor_requests_completed_total"):
                print(f"[frontdoor] {line}")
    finally:
        fd.close()
    return {rid: list(outcomes[rid].result) for rid in rids}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--arch", default="qwen3-14b", help="the decoder-only architecture served",
                    choices=[a for a in ARCH_IDS if get_smoke(a).family != "encdec"])
    args = ap.parse_args(argv)
    traits = DeviceTraits(type=DeviceType.CPU) if args.cpu else DeviceTraits()
    app = CLapp().init(device_traits=traits)
    out = {args.arch: serve_transformer(app, args.arch), "whisper": serve_whisper(app),
           "frontdoor": serve_front_door(app)}
    print("all requests completed")
    return out


if __name__ == "__main__":
    main()
