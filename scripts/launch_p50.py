"""Replay p50 of ``SimpleMRIRecon.launch()`` at ``CONFIG`` on the card,
unprofiled and profiled, in the staged, fused and fused_kernel modes.

    PYTHONPATH=src python3 scripts/launch_p50.py [--reps 200]

Each mode: a new app and process, three unprofiled launches (eager, the
capture, a replay), then ``--reps`` unprofiled launches, each between two
CUDA events on the compute stream (the p50 of those intervals), then three
profiled launches and ``--reps`` more, whose samples give the profiled
p50.  A profiled launch of a staged chain may replay a graph of its own,
with each stage's timing events in it: the lines print the device memory
that the profiled launches kept allocated (a second graph's pool).

The script uses only what every slice of the port has (``CLapp``,
``SimpleMRIRecon``, ``ProfileParameters``), and imports whichever
``repro_torch`` comes first on ``PYTHONPATH``, so one call can time two
trees in turn: ``PYTHONPATH=<tree>/src python3 scripts/launch_p50.py``.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="launch_p50.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("launch_p50.py: no CUDA device")
    import repro_torch
    from repro_torch.configs.mri_recon import CONFIG
    from repro_torch.core import CLapp, KData, ProfileParameters, XData
    from repro_torch.launch.mri_recon import synthetic_kdata
    from repro_torch.processes import SimpleMRIRecon

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True, check=True).stdout.strip()
    cfg = (CONFIG.frames, CONFIG.coils, CONFIG.height, CONFIG.width)
    kdata, smaps, _ = synthetic_kdata(*cfg)
    print(f"[launch_p50] {smi}; repro_torch from {repro_torch.__file__}")
    for mode in ("staged", "fused", "fused_kernel"):
        app = CLapp().init()
        proc = SimpleMRIRecon(app, mode=mode, in_place=False)
        proc.in_handle = app.addData(KData({"kdata": kdata, "sensitivity_maps": smaps}))
        proc.out_handle = app.addData(XData({"xdata": np.zeros((cfg[0],) + cfg[2:],
                                                               np.complex64)}))
        proc.init()
        for _ in range(3):
            proc.launch()
        times = []
        for _ in range(args.reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            proc.launch()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        prof = ProfileParameters(enable=True)
        for _ in range(3):
            proc.launch(prof)
        kept = torch.cuda.memory_allocated() - before
        prof = ProfileParameters(enable=True)
        for _ in range(args.reps):
            proc.launch(prof)
        chain = proc.chain
        print(f"[launch_p50] {mode} at {cfg}: unprofiled replay p50 "
              f"{statistics.median(times):.5f} ms (min {min(times):.5f}, max {max(times):.5f}) "
              f"over {args.reps}; profiled p50 {statistics.median(prof.samples) * 1e3:.5f} ms "
              f"(min {min(prof.samples) * 1e3:.5f}); captures {chain.captures}, replays "
              f"{chain.replays}; device memory kept by the profiled launches {kept / 1e6:.3f} MB")
        del proc, app
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
