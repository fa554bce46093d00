"""How the MRI stream scales over cards: ``SimpleMRIRecon.stream`` at
``CONFIG`` (16 frames x 8 coils x 160x160) over 1, 2 and 4 cards, the
equal (``sharded=True``) and the proportional split, with each card's idle
share over a traced stream.

    python3 scripts/mesh_scaling.py [--cards 1 2 4] [--slices 48] [--batch 8]
        [--mode fused_kernel] [--out PATH]

Runs only on CUDA cards (on a machine with fewer cards it measures the
counts it can).  For each card count: an app over the first N cards
(``CLapp().init(device_traits=DeviceTraits(count=N))``, one lane a card),
two untimed streams (twins set up and captured), three timed (wall ms a
slice, the median), the split vectors of the last, then one stream under
``torch.profiler``: each card's kernel busy time within the stream's
window (a ``record_function`` span on the host) and its idle share.  Every
output is held against the one-card stream's (bit for bit in the kernel
mode, rtol 1e-6 under cuFFT).  Prints a line a cell and, with ``--out``,
writes the cells as JSON there.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _busy(trace_path: str, n_cards: int):
    """Per card: kernel busy ms within the "stream" span, and the span's ms."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    span = next(e for e in events if e.get("name") == "stream" and e.get("ph") == "X"
                and e.get("cat") == "user_annotation")      # the host's span, not the GPU's
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    per = {}
    for e in events:
        if e.get("cat") != "kernel" or not e.get("dur"):
            continue
        dev = int((e.get("args") or {}).get("device", 0))
        a, b = max(t0, float(e["ts"])), min(t1, float(e["ts"]) + float(e["dur"]))
        if b > a:
            per.setdefault(dev, []).append((a, b))
    busy = {}
    for dev in range(n_cards):
        merged = []
        for a, b in sorted(per.get(dev, [])):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy[dev] = sum(b - a for a, b in merged) / 1e3
    return busy, (t1 - t0) / 1e3


def main(argv=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--slices", type=int, default=48)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mode", default="fused_kernel",
                    choices=["staged", "fused", "fused_kernel"])
    ap.add_argument("--out", help="write the cells as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("mesh_scaling: no CUDA card; this script measures on the card only")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.mri_recon import CONFIG
    from repro_torch.core import CLapp, DeviceTraits, KData, XData
    from repro_torch.launch.mri_recon import synthetic_kdata
    from repro_torch.processes import SimpleMRIRecon

    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    print(cards)                        # a line a card
    smi = cards.splitlines()[0]
    cfg = (CONFIG.frames, CONFIG.coils, CONFIG.height, CONFIG.width)
    slices = []
    for i in range(args.slices):
        k, sm, _ = synthetic_kdata(*cfg, seed=100 + i)
        slices.append(KData({"kdata": k, "sensitivity_maps": sm}))
    exact = args.mode == "fused_kernel"
    have = torch.cuda.device_count()
    results, want = [], None
    tmp = tempfile.TemporaryDirectory(prefix="mesh_scaling_")
    for n in [c for c in args.cards if c <= have]:
        app = CLapp().init(device_traits=DeviceTraits(count=n))
        h_in = app.addData(KData({"kdata": slices[0].kdata.host,
                                  "sensitivity_maps": slices[0].smaps.host}))
        h_out = app.addData(XData({"xdata": np.zeros((cfg[0],) + cfg[2:], np.complex64)}))
        proc = SimpleMRIRecon(app, mode=args.mode, in_place=False)
        proc.in_handle, proc.out_handle = h_in, h_out
        proc.init()
        for split in ("equal", "proportional"):
            kw = dict(batch=args.batch, sharded=True, split=split)
            for _ in range(2):
                proc.stream(slices, **kw)
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                outs = proc.stream(slices, **kw)
                for d in range(n):
                    torch.cuda.synchronize(d)
                walls.append((time.perf_counter() - t0) * 1e3)
            got = [o.device_view("xdata").cpu().numpy() for o in outs]
            if want is None:
                want = got
            for i, (g, w) in enumerate(zip(got, want)):
                if exact:
                    np.testing.assert_array_equal(g, w, err_msg=f"{n} cards {split} {i}")
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                               err_msg=f"{n} cards {split} {i}")
            vectors = list(proc.chain.split_vectors)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tr:
                with record_function("stream"):
                    proc.stream(slices, **kw)
                    for d in range(n):
                        torch.cuda.synchronize(d)
            path = os.path.join(tmp.name, f"trace_{n}_{split}.json")
            tr.export_chrome_trace(path)
            busy, window = _busy(path, n)
            ms = statistics.median(walls) / args.slices
            idle = {d: round(1 - b / window, 4) for d, b in busy.items()}
            row = {"cards": n, "split": split, "mode": args.mode, "ms_per_slice": ms,
                   "walls_ms": walls, "vectors": vectors[-3:], "busy_ms": busy,
                   "traced_window_ms": window, "idle_share": idle,
                   "rates": app.device_profiles.rates(range(n)) if split == "proportional"
                   else None}
            results.append(row)
            print(f"[mesh-scaling] {smi}: {n} card(s), {split}, {args.mode}, {args.slices} "
                  f"slices at batch {args.batch}: {ms:.3f} ms a slice (timed walls "
                  f"{', '.join(f'{w:.1f}' for w in walls)} ms); split vectors "
                  f"{vectors[-3:]}; traced stream {window:.1f} ms, kernel busy ms a card "
                  f"{ {d: round(b, 2) for d, b in busy.items()} }, idle share {idle}")
        proc.chain._release_stream()
        del app, proc
        torch.cuda.empty_cache()
    tmp.cleanup()
    report = {"cards": cards.splitlines(), "cells": results}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
