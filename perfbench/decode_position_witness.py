#!/usr/bin/env python3
"""Witness of a fault of the program's continuous batching, held against
the plain reference: the same prompts served together in one
``LMServer`` (slots at different positions) and one at a time.

    python3 perfbench/decode_position_witness.py --seeds <n> [<n> ...] \\
        [--slots 32] [--new 32] [--checked 4]

``DecodeStep`` decodes every slot at the largest position of the batch
(``positions.max()``), so a slot whose prompt is shorter than another's
gets its new tokens' rotary positions and cache entries at the batch's
position, not its own.  For each seed this draws ``slots`` chat prompts
(log-normal lengths, median 1024, sigma 0.7, clipped to 64-2048; the
shape of the Azure LLM inference conversation trace), serves them together, then serves ``checked`` of them (the
shortest first) alone, each in a fresh server of the same shape, and
prints the widest gap by which a served token's logit lies below the f32
reference's best, both ways.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

#: the chat prompts' lengths, and the servers' cache length (prompt + 128)
PROMPT = {"median": 1024, "sigma": 0.7, "min": 64, "max": 2048}
MAX_LEN = 2176


def prompts(seed: int, n: int, vocab: int):
    """``n`` prompts of ``seed``: the lengths at the distribution's
    quantiles (i + 0.5) / n in the seed's order, ids uniform over the
    vocabulary."""
    from statistics import NormalDist
    import numpy as np
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    lens = np.rint(np.clip(PROMPT["median"] * np.exp(PROMPT["sigma"] * z), PROMPT["min"],
                           PROMPT["max"])).astype(np.int64)
    lens = np.random.default_rng([int(seed), 1]).permutation(lens)
    return [np.random.default_rng([int(seed), 7, 0, i]).integers(0, vocab, size=int(m)).tolist()
            for i, m in enumerate(lens)]


def serve(cfg, prompts, slots, max_len, new, seed, device):
    from perfbench.drivers.common import app_for
    from perfbench.drivers.lm_common import program_model
    from perfbench import weights
    from repro_torch.processes import weights_data
    from repro_torch.serve import LMServer, SamplingConfig
    import torch
    model = program_model(cfg)
    wdata, _ = weights_data(model.param_specs())
    server = LMServer(model, wdata, batch=slots, max_len=max_len,
                      sampling=SamplingConfig(max_new_tokens=new), app=app_for(device))
    flat, made = weights.make_flat(cfg, seed, device)
    with torch.no_grad():
        for name, t in wdata.device_views().items():
            t.copy_(made[name[1:]])
    del flat, made
    rids = [server.submit(p) for p in prompts]
    server.run()
    return [list(server.results[r]) for r in rids]


def main() -> int:
    from perfbench.harness import set_cache_dirs
    set_cache_dirs()
    import torch
    from perfbench import weights
    from perfbench.drivers.common import free
    from perfbench.reference import decoder_lm
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--checked", type=int, default=4)
    ap.add_argument("--control", default=None,
                    help="also the gap of the token this lower precision puts first (fp8)")
    ap.add_argument("--cpu", action="store_true", help="a small model on the CPU")
    args = ap.parse_args()
    cfg = json.loads((ROOT / "perfbench/configs/h2o-danube-1.8b.json").read_text())
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    if args.cpu:
        cfg.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                   vocab=128)
    for seed in args.seeds:
        drawn = prompts(seed, args.slots, int(cfg["vocab"]))
        together = serve(cfg, drawn, args.slots, MAX_LEN, args.new, seed, device)
        free(device)
        order = sorted(range(len(drawn)), key=lambda i: len(drawn[i]))[:args.checked]
        alone = {}
        for i in order:
            alone[i] = serve(cfg, [drawn[i]], args.slots, MAX_LEN, args.new, seed, device)[0]
            free(device)
        _, made = weights.make_flat(cfg, seed, device)
        params = {n: t.float() for n, t in made.items()}
        del made, _
        for i in order:
            g_t = decoder_lm.served_gaps(cfg, params, drawn[i] + together[i], len(drawn[i]))
            g_a = decoder_lm.served_gaps(cfg, params, drawn[i] + alone[i], len(drawn[i]),
                                         args.control)
            print(json.dumps({"seed": seed, "prompt_len": len(drawn[i]),
                              "longest_in_batch": max(map(len, drawn)),
                              "gap_together": g_t["served"], "gap_alone": g_a["served"],
                              "control_alone": g_a.get("control"),
                              "same_tokens": together[i] == alone[i]}), flush=True)
        del params
        free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
