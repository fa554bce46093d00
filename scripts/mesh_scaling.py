"""How the MRI stream scales over cards: ``SimpleMRIRecon.stream`` at
``CONFIG`` (16 frames x 8 coils x 160x160) over 1, 2 and 4 cards, the
equal (``sharded=True``) and the proportional split, with each card's idle
share over a traced stream.

    python3 scripts/mesh_scaling.py [--cards 1 2 4] [--slices 48] [--batch 8]
        [--mode fused_kernel] [--lm ARCH] [--tp ARCH [ARCH ...]] [--out PATH]

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

``--lm ARCH`` also runs the LM stack over the same card counts, each card
a lane (distinct cards: eager steps, cross-card copies between them): ARCH
trained at full width at batch 4 x 2048 (``Trainer(mesh=)``, 2 steps, then
the step ms of 3 more), its state and metrics held bit for bit against a
one-card ``TrainProcess(microbatches=N)``; and ARCH served over a
(data 1, model N) group (10 requests, 4 slots), its tokens held against
the same group with every strip on card 0 and its decode p50 beside it.

``--tp ARCH [ARCH ...]`` trains each ARCH (any family) at full width at
batch 4 x 2048 (zamba2-2.7b 1 x 2048, whisper-large-v3 2 x 448 with 1500
frames a sample: without remat their activations outgrow a card) over a
(data 1, model N) group of N distinct cards, tensor parallel (eager
steps; a lane's sums through the first card), for each card count above 1
(a count that does not divide the vocabulary or the heads is skipped,
named): after 2 steps its state and metrics held bit for bit against the
same group on card 0 named N times (one CUDA graph a step), and the step
ms of 3 more beside that group's.
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


def lm_cells(arch: str, counts, smi: str) -> list:
    """The ``--lm`` cells: training and serving ``arch`` over 1, 2, 4 cards."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import CLapp, DeviceTraits
    from repro_torch.core.arena import tree_flatten
    from repro_torch.data.pipeline import StreamConfig, TokenStream
    from repro_torch.launch.mesh import Mesh, make_data_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, Schedule
    from repro_torch.processes.lm import weights_data
    from repro_torch.serve import LMServer, SamplingConfig
    from repro_torch.train import (TrainConfig, Trainer, TrainerConfig, TrainProcess,
                                   make_train_state)

    cfg = get_config(arch)
    model = build_model(cfg)
    stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=2048, batch=4, seed=0))
    opt = AdamWConfig(schedule=Schedule(kind="constant", base_lr=1e-5, warmup_steps=0))
    cuda = [torch.device("cuda", i) for i in range(max(counts))]
    cells = []
    for n in counts:
        state = make_train_state(model, 0, device=cuda[0])
        proc = TrainProcess(model, TrainConfig(microbatches=n, opt=opt)).init(
            state, stream.batch_at(0))
        for i in range(2):
            state, metrics = proc.launch(state, stream.batch_at(i))
        want = {k: v.cpu() for k, v in tree_flatten(state)}
        want_metrics = {k: v.cpu() for k, v in metrics.items()}
        del proc, state, metrics
        gc.collect()
        torch.cuda.empty_cache()
        trainer = Trainer(model, TrainerConfig(total_steps=2, log_every=1,
                                               train=TrainConfig(opt=opt)),
                          mesh=make_data_mesh(cuda[:n]), log_fn=lambda _m: None)
        placed = trainer.fit(stream, 0)
        differ = [name for name, s in tree_flatten(placed) for k, p in enumerate(s.pieces)
                  if not torch.equal(p.cpu(), want[name][s.slices(k)])]
        differ += [k for k, v in want_metrics.items()
                   if not torch.equal(trainer.process.metrics[k].cpu(), v)]
        step_ms = []
        for i in range(3):
            for d in cuda[:n]:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            trainer.process.launch(placed, stream.batch_at(2 + i))
            for d in cuda[:n]:
                torch.cuda.synchronize(d)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        p50 = statistics.median(step_ms)
        graphs = (trainer.process.captures, trainer.process.replays)
        print(f"[mesh-scaling] {smi}: {arch} trained over {n} card(s) at 4 x 2048: step ms "
              f"{', '.join(f'{t:.2f}' for t in step_ms)}, p50 {p50:.2f}, "
              f"{4 * 2048 / p50 * 1e3:.0f} tokens/s; captures, replays {graphs}; state "
              f"and metrics bit for bit the one-card microbatches={n} step: {not differ} "
              f"{differ[:4]}")
        cells.append({"lm": arch, "part": "train", "cards": n, "step_ms": step_ms,
                      "p50_ms": p50, "captures_replays": graphs, "bit_for_bit": not differ})
        del trainer, placed, want
        gc.collect()
        for d in cuda[:n]:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
        if differ:
            raise SystemExit(f"mesh_scaling: {arch} over {n} cards differs: {differ[:4]}")

    def served(group):
        app = CLapp().init(device_traits=DeviceTraits(count=1))
        app.set_mesh(Mesh([group]))
        weights, wcodec = weights_data(model.param_specs())
        app.addData(weights)
        model.init_params(torch.Generator(device=app.device).manual_seed(0),
                          out=wcodec.unflatten(weights.device_views()))
        server = LMServer(model, weights, batch=4, max_len=2048,
                          sampling=SamplingConfig(max_new_tokens=32), app=app)
        rng = np.random.default_rng(0)
        for n in rng.integers(17, 1025, size=10):
            server.submit(rng.integers(0, cfg.vocab, int(n)).tolist())
        tokens = server.run()
        return tokens, statistics.median(server.decode_profile.samples) * 1e3

    for n in [c for c in counts if c > 1 and 4 % c == 0]:
        want, one_p50 = served([cuda[0]] * n)
        got, p50 = served(cuda[:n])
        same = got == want
        print(f"[mesh-scaling] {smi}: {arch} served over a (data 1, model {n}) group of {n} "
              f"cards (strips copied to their card, a weights replica a card, eager): decode "
              f"p50 {p50:.3f} ms against {one_p50:.3f} with every strip on card 0 (one graph); "
              f"tokens equal {same}")
        cells.append({"lm": arch, "part": "serve", "cards": n, "decode_p50_ms": p50,
                      "one_card_p50_ms": one_p50, "tokens_equal": same})
        gc.collect()
        if not same:
            raise SystemExit(f"mesh_scaling: {arch} served over {n} cards: tokens differ")
    return cells


def tp_cells(arch: str, counts, smi: str) -> list:
    """The ``--tp`` cells: ``arch`` over a (1, N) model group of N cards
    against the same group on card 0."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.arena import tree_flatten
    from repro_torch.data.pipeline import StreamConfig, TokenStream
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, Schedule
    from repro_torch.train import TrainConfig, TrainProcess, init_mesh_state

    from repro_torch.train.step import check_train_mesh

    model = build_model(get_config(arch))
    cfg = model.cfg
    frames = 1500 if cfg.family == "encdec" else 0
    # over distinct cards a group keeps every layer's activations (no remat:
    # ModelGroup.one_device), which fits rwkv6-3b's batch of 4 x 2048 but not
    # zamba2-2.7b's (its f32 SSD) or whisper-large-v3's 8 x 448: those run a
    # quarter of it
    batch, seq = {"hybrid": (1, 2048), "encdec": (2, 448)}.get(cfg.family, (4, 2048))
    kw = dict(kind="encdec", d_model=cfg.d_model, enc_frames=frames) if frames else {}
    stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=seq, batch=batch, seed=0, **kw))
    tcfg = TrainConfig(opt=AdamWConfig(schedule=Schedule(kind="constant", base_lr=1e-5,
                                                         warmup_steps=0)))
    cuda = [torch.device("cuda", i) for i in range(max(counts))]

    def run(devices):
        """(pieces on the host, metrics, step ms of 3 more, captures) of 2
        steps over the group, then 3 timed."""
        mesh = make_data_mesh(devices, model=len(devices))
        state = init_mesh_state(model, 0, mesh)
        proc = TrainProcess(model, tcfg, mesh=mesh).init(state, stream.batch_at(0))
        for i in range(2):
            metrics = proc.launch(state, stream.batch_at(i))[1]
        pieces = {name: [p.cpu() for p in s.pieces] for name, s in tree_flatten(state)}
        metrics = {k: v.cpu() for k, v in metrics.items()}
        step_ms = []
        for i in range(3):
            for d in set(devices):
                torch.cuda.synchronize(d)
            bt = stream.batch_at(2 + i)     # made on the host before the timed span
            t0 = time.perf_counter()
            proc.launch(state, bt)
            for d in set(devices):
                torch.cuda.synchronize(d)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        captures = proc.captures
        del proc, state
        gc.collect()
        for d in set(devices):
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
        return pieces, metrics, step_ms, captures

    cells = []
    for n in [c for c in counts if c > 1]:
        try:
            check_train_mesh(make_data_mesh([cuda[0]] * n, model=n), model)
        except ValueError as e:
            print(f"[mesh-scaling] {arch} over a model group of {n} cards: skipped ({e})")
            continue
        want, want_metrics, one_ms, one_captures = run([cuda[0]] * n)
        got, metrics, step_ms, captures = run(cuda[:n])
        differ = [(name, k) for name in want for k, (p, q) in
                  enumerate(zip(got[name], want[name])) if not torch.equal(p, q)]
        differ += [k for k in want_metrics if not torch.equal(metrics[k], want_metrics[k])]
        p50, one_p50 = statistics.median(step_ms), statistics.median(one_ms)
        print(f"[mesh-scaling] {smi}: {arch} trained over a (data 1, model {n}) group of {n} "
              f"cards at {batch} x {seq} (eager, captures {captures}): step ms "
              f"{', '.join(f'{t:.2f}' for t in step_ms)}, p50 {p50:.2f}, "
              f"{batch * seq / p50 * 1e3:.0f} tokens/s; the group on card 0 ({one_captures} "
              f"capture) p50 {one_p50:.2f}; state and metrics after 2 steps bit for bit the "
              f"card-0 group's: {not differ} {differ[:4]}")
        cells.append({"tp": arch, "cards": n, "step_ms": step_ms, "p50_ms": p50,
                      "one_card_step_ms": one_ms, "one_card_p50_ms": one_p50,
                      "bit_for_bit": not differ})
        del want, got
        if differ:
            raise SystemExit(f"mesh_scaling: {arch} over a model group of {n} cards differs: "
                             f"{differ[:4]}")
    return cells


def main(argv=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--slices", type=int, default=48)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mode", default="fused_kernel",
                    choices=["staged", "fused", "fused_kernel"])
    ap.add_argument("--lm", metavar="ARCH", help="also train and serve ARCH over the cards")
    ap.add_argument("--tp", metavar="ARCH", nargs="+", default=[],
                    help="also train each ARCH over a model group of the cards (tensor "
                         "parallel)")
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
    if args.lm:
        results += lm_cells(args.lm, [c for c in args.cards if c <= have], smi)
    for arch in args.tp:
        results += tp_cells(arch, [c for c in args.cards if c <= have], smi)
    report = {"cards": cards.splitlines(), "cells": results}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
