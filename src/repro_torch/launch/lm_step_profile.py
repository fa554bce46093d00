#!/usr/bin/env python3
"""Where the time of the port's LM serving path goes, on one CUDA card.

    python3 src/repro_torch/launch/lm_step_profile.py [--arch A] [--layers N] [--batch B]
                                                      [--prompt S] [--steps K] [--max-len M]

Builds ``--arch`` (qwen3-14b by default, or any other architecture of
``repro_torch.configs.ARCH_IDS``: minitron-8b, granite-moe-1b-a400m,
deepseek-v2-lite-16b, rwkv6-3b, whisper-large-v3, zamba2-2.7b,
internvl2-2b, ...) at full width (``--layers`` cuts only the depth, of the
encoder and the decoder alike for whisper, counts deepseek's dense layer
0, and must be a multiple of zamba2's ``attn_every``, 6, whole
superblocks; random bf16 weights made on the card from seed 0) in a fresh
process, and prints:

1. **The first prefill, split.**  The kernel library's build and load, the
   first cuBLAS call (handle and workspace), then three single-prompt
   prefill launches of 1024 tokens, 1024 again and 700 (new GEMM shapes;
   224, 224 and 150 for whisper, each over 1500 frames, Whisper's 30 s
   window, through the fan-in prefill graph of ``DecodeSession``),
   each eager (a prefill is never captured; its pipe is built before,
   untimed, as ``LMServer``'s prefill profile times only the launch) and
   traced with
   ``torch.profiler``: host wall (ending in a
   synchronize), device busy time, the new allocator segments
   (``cudaMalloc`` calls), the peak memory the launch allocated on top
   of what was there (its activations: zamba2's f32 SSD temporaries) and
   the host time of the CUDA runtime calls, so
   the first call's extra time shows where it went.
2. **The decode step, eager and compiled, in the same process.**  A batch
   of ``--batch`` prompts of ``--prompt`` tokens prefilled through
   ``DecodeSession`` (a cache of ``--max-len`` positions, 2048 by default),
   then ``--steps`` steps traced eagerly (``init()``
   before each step, outside the timed region, keeps the launch eager) and
   ``--steps`` steps replayed from the step's CUDA graph.  For each: host
   wall per step without the profiler (and under it), device busy time
   (the sum of the CUDA kernels' self time in the trace), the device's idle
   share of the wall without the profiler, the kernels a step runs, the
   host's CUDA launch calls a step (kernel launches, graph launches,
   copies) and the launch's own time from CUDA events, and the kernels
   and host-side operators that take the most time.
3. **What a capture costs.**  The decode step's capture, split into what
   ``torch.cuda.graph`` does before it records (a synchronize,
   ``gc.collect`` where torch's ``force_cudagraph_gc`` asks for it,
   ``empty_cache``) and the recording itself with the
   first replay; a 1024-token prefill just before and just after that
   capture (wall and new allocator segments: ``empty_cache`` hands the
   cached blocks back); and ``CacheSplice`` and ``SlotRelease`` (eager in
   the port) against a copy of each that is captured: the eager launch,
   the capturing launch and a replay, host wall with a synchronize, and
   the launches a capture needs to pay for itself.

Exits non-zero without a CUDA card, or when the eager trace holds no
device time.
"""
from __future__ import annotations

import argparse
import gc
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2]
# the host's CUDA calls that put work on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
ENC_LEN = 1500                              # whisper's encoder frames: its 30 s window


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(SRC))
    from repro_torch.configs import ARCH_IDS, get_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=ARCH_IDS)
    ap.add_argument("--layers", type=int, default=None, help="default: the config's depth")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--max-len", type=int, default=2048, help="decode cache positions")
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.layers and cfg.attn_every and args.layers % cfg.attn_every:
        ap.error(f"--layers {args.layers}: {args.arch} needs a multiple of attn_every "
                 f"({cfg.attn_every})")
    if not torch.cuda.is_available():
        sys.exit("lm_step_profile: no CUDA card")
    from repro_torch.core import CLapp, Data, ProfileParameters, process
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.processes import DecodeSession, weights_data
    from repro_torch.processes.lm import CacheSplice, SlotRelease

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    encdec = cfg.family == "encdec"
    if encdec and args.layers:
        cfg = cfg.scaled(enc_layers=args.layers, dec_layers=args.layers, n_layers=2 * args.layers)
    elif args.layers:
        cfg = cfg.scaled(n_layers=args.layers)
    long, short = (224, 150) if encdec else (1024, 700)

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # -- 1. the first prefill, split ------------------------------------------
    app = CLapp().init()
    t_lib = wall_ms(_build.library)
    a = torch.randn(64, 64, device=app.device, dtype=torch.bfloat16)
    t_blas = [wall_ms(lambda: a @ a) for _ in range(2)]
    info = _build.BUILD_INFO
    print(f"[first] {smi}: kernel library {t_lib:.2f} ms (nvcc {info['seconds']:.2f} s, "
          f"cached={info['cached']}); first cuBLAS call (64x64 bf16) "
          f"{t_blas[0]:.2f} ms, second {t_blas[1]:.3f} ms; cuFFT is not on this path")
    model = build_model(cfg)
    weights, codec = weights_data(model.param_specs())
    app.addData(weights)
    model.init_params(torch.Generator(device=app.device).manual_seed(0),
                      out=codec.unflatten(weights.device_views()))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (a @ a).sum()                       # the profiler's own start-up, not timed
    rng = np.random.default_rng(0)
    enc_len = ENC_LEN if encdec else None

    def session(batch):
        return DecodeSession(app, model, weights, batch=batch, max_len=args.max_len,
                             enc_len=enc_len)

    def prompts(batch, length):
        """(tokens, frames or None) of ``batch`` prompts of ``length`` tokens."""
        toks = rng.integers(0, cfg.vocab, (batch, length)).astype(np.int32)
        return toks, (rng.standard_normal((batch, enc_len, cfg.d_model), dtype=np.float32)
                      if encdec else None)

    def traced_once(label, sess, inputs):
        """One prefill launch under the profiler (its pipe built and
        initialised before, untimed, so the launch is eager): wall, device
        busy, new allocator segments, and the host's CUDA runtime calls by
        name."""
        toks, frames = inputs
        sess.prefill_pipe.build({"tokens": Data({"tokens": toks}), "frames": Data(
            {"frames": frames})} if encdec else Data({"tokens": toks}))
        segs = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.prefill(toks, frames=frames)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type.name == "CUDA") / 1e3
        host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key) for e in events
                       if e.device_type.name == "CPU"), reverse=True)
        runtime = [h for h in host if h[2].startswith("cu")]
        ops = [h for h in host if not h[2].startswith("cu")]
        new_segs = torch.cuda.memory_stats().get("segment.all.allocated", 0) - segs
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        print(f"[first] {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, {new_segs} new "
              f"allocator segments, peak {peak:.3f} GB above what was allocated before "
              f"(weights, states); host CUDA calls {sum(h[0] for h in runtime):.2f} ms: "
              + ", ".join(f"{k} {ms:.2f} ms x{n}" for ms, n, k in runtime[:6])
              + f"; other host ops {sum(h[0] for h in ops):.2f} ms: "
              + ", ".join(f"{k} {ms:.2f} ms x{n}" for ms, n, k in ops[:6]))
        return wall

    row = session(1)
    toks = prompts(1, long)
    first = traced_once(f"{cfg.name} prefill 1 x {long}, first call", row, toks)
    second = traced_once(f"{cfg.name} prefill 1 x {long}, second call", row, toks)
    other = session(1)
    traced_once(f"{cfg.name} prefill 1 x {short}, first call at this length", other,
                prompts(1, short))
    print(f"[first] {smi}: first / second prefill of 1 x {long}: {first / second:.2f}")
    del other

    # -- 2. the decode step, eager and compiled ---------------------------------
    sess = session(args.batch)
    p_toks, p_frames = prompts(args.batch, args.prompt)
    sess.prefill(p_toks, frames=p_frames)
    step = sess.decode_pipe.build().executor

    def steps_ms(fn, reps, prep, prof_launch):
        walls = []
        for _ in range(reps):
            if prep is not None:
                prep()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(prof_launch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.mean(walls)

    def traced(label, fn, reps, prep=None):
        """``reps`` steps without the profiler (the wall, and the launch's
        CUDA-event time), then ``reps`` under it (device busy, kernels and
        host calls); the idle share is 1 - busy / the wall without it."""
        prof_launch = ProfileParameters(enable=True)
        wall = steps_ms(fn, reps, prep, prof_launch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced_wall = steps_ms(fn, reps, prep, ProfileParameters())
        events = prof.key_averages()
        dev = [e for e in events if e.device_type.name == "CUDA"]
        busy = sum(e.self_device_time_total for e in dev) / reps / 1e3
        cpu = [e for e in events if e.device_type.name == "CPU"]
        host_calls = {e.key: e.count / reps for e in cpu if e.key in LAUNCH_CALLS}
        busy_txt = (f"device busy {busy:.3f} ms, device idle {100 * (1 - busy / wall):.1f} %"
                    if busy > 0 else "device busy not measured (the trace holds no kernels)")
        print(f"[{label}] {smi}: wall {wall:.3f} ms a step (mean of {reps}; {traced_wall:.3f} "
              f"under the profiler), {busy_txt}, "
              f"{sum(e.count for e in dev) / reps:.0f} kernels a step; host launch calls a "
              f"step {sum(host_calls.values()):.0f} ("
              + ", ".join(f"{k} {n:.0f}" for k, n in sorted(host_calls.items()))
              + f"); launch (CUDA events) p50 {prof_launch.p50() * 1e3:.3f} ms")
        for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  device {e.self_device_time_total / reps / 1e3:8.3f} ms  "
                  f"x{e.count / reps:6.0f}  {e.key[:100]}")
        for e in sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:8]:
            print(f"  host   {e.self_cpu_time_total / reps / 1e3:8.3f} ms  "
                  f"x{e.count / reps:6.0f}  {e.key[:100]}")
        return busy

    for _ in range(3):                       # warm-up: allocator, cuBLAS
        step.init()
        sess.step()
    what = (f"{cfg.name} decode step, batch {args.batch}, max_len {args.max_len}, "
            + (f"{cfg.dec_layers} decoder layers over {enc_len} frames" if encdec
               else f"{cfg.n_layers} layers"))
    busy = traced(f"{what}, eager", lambda p: sess.step(p), args.steps, prep=step.init)
    if busy <= 0:
        sys.exit("lm_step_profile: the eager decode trace holds no device time")

    # -- 3. what a capture costs ------------------------------------------------
    split = {}
    plain_capture = process.capture_graph

    # torch.cuda.graph collects garbage first only under this flag (older
    # releases, without the flag, always did)
    capture_gc = getattr(getattr(torch.compiler, "config", None), "force_cudagraph_gc", True)

    def timed_capture(body, device):
        """The seam, with what ``torch.cuda.graph`` does first done and
        timed here (its own repeat of it then finds nothing to do)."""
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if capture_gc:
            gc.collect()
        t2 = time.perf_counter()
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        replay = plain_capture(body, device)
        torch.cuda.synchronize()
        split.update(synchronize=t1 - t0, gc_collect=t2 - t1, empty_cache=t3 - t2,
                     record=time.perf_counter() - t3)
        return replay

    before = traced_once(f"{cfg.name} prefill 1 x {long}, just before the decode capture",
                         row, toks)
    process.capture_graph = timed_capture
    try:
        capturing = wall_ms(sess.step)       # captures the step, then replays it
    finally:
        process.capture_graph = plain_capture
    after = traced_once(f"{cfg.name} prefill 1 x {long}, just after the decode capture",
                        row, toks)
    print(f"[capture] {smi}: {what}: the capturing step {capturing:.3f} ms (torch "
          f"{torch.__version__}, gc.collect in a capture: {bool(capture_gc)}): "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in split.items())
          + f"; a {long}-token prefill {before:.3f} ms before it, {after:.3f} ms after it")
    sess.step()
    traced(f"{what}, CUDA graph", lambda p: sess.step(p), args.steps)
    print(f"[{what}] graph captures {step.captures}, replays {step.replays}")

    def eager_against_captured(cls, wire, reps=20):
        """Host wall (with a synchronize) of ``cls``'s eager launch, and of
        a captured copy's capturing launch and replay."""
        eager = cls(app, 0)
        wire(eager)
        eager.launch()
        eager_ms = statistics.median(wall_ms(eager.launch) for _ in range(reps))
        graphed = type(f"Captured{cls.__name__}", (cls,), {"graphed": True})(app, 0)
        wire(graphed)
        graphed.launch()                     # eager: the warm-up
        capture_ms = wall_ms(graphed.launch)
        replay_ms = statistics.median(wall_ms(graphed.launch) for _ in range(reps))
        saved = eager_ms - replay_ms
        pays = f"after {capture_ms / saved:.0f} launches" if saved > 0 else "never"
        print(f"[capture] {smi}: {cls.__name__} on slot 0 of the batch-{args.batch} state: "
              f"eager {eager_ms:.3f} ms a launch (median of {reps}), capturing launch "
              f"{capture_ms:.3f} ms, replay {replay_ms:.3f} ms (captures {graphed.captures}, "
              f"replays {graphed.replays}); a capture pays for itself {pays}")

    def splice_wiring(p):
        p.in_handles["in"] = p.out_handle = sess.state_h
        p.in_handles["row"] = row.state_h

    def release_wiring(p):
        p.in_handles["in"] = p.out_handle = sess.state_h

    eager_against_captured(CacheSplice, splice_wiring)
    eager_against_captured(SlotRelease, release_wiring)


if __name__ == "__main__":
    main()
