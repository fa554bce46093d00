"""A backward kernel's device times and the replayed training step's p50 at
full width, on the card, measured by ``chip_smoke.py``'s own functions.

    PYTHONPATH=src python3 scripts/train_step_p50.py [--arch h2o-danube-1.8b|rwkv6-3b]

``--arch h2o-danube-1.8b`` (the default): ``chip_smoke.backward_times``,
``rmsnorm_bwd`` at x (8192, 2560) bf16 beside ``F.rms_norm``'s backward,
and ``flash_attention_bwd`` at an h2o-danube-1.8b layer (q (4, 32, 2048,
80), k and v (4, 8, 2048, 80), bf16, causal, window 4096) beside SDPA's
backward (``enable_gqa``).  ``--arch rwkv6-3b``:
``chip_smoke.wkv6_bwd_times``, ``wkv6_bwd`` at a rwkv6-3b layer ((4, 2048,
40, 64) bf16, no state) with the training forward's checkpoints, beside
that forward and the serving one.  Then ``chip_smoke.fit_and_time``: the
architecture at full width (random bf16 weights from seed 0), 6
``Trainer`` steps at batch 4 x 2048, then 5 replayed steps between CUDA
events (p50, tokens/s, MFU at the card's bf16 tensor rate, peak memory)
and one replayed step under ``torch.profiler``.

The measuring code is this tree's ``chip_smoke.py``; ``repro_torch`` is
whichever comes first on ``PYTHONPATH``, so one call can time two trees
in turn, each in a fresh process, with one definition of each number:
``PYTHONPATH=<tree>/src python3 scripts/train_step_p50.py --arch ...``.
Its last line is one JSON object of the numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # chip_smoke.py

import chip_smoke  # noqa: E402

ARCHS = ("h2o-danube-1.8b", "rwkv6-3b")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default=ARCHS[0])
    arch = ap.parse_args(argv).arch
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("train_step_p50.py: no CUDA device")
    import repro_torch
    from repro_torch.launch.roofline import card_peaks

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True, check=True).stdout.strip()
    print(f"[train_step_p50] {smi}; repro_torch from {repro_torch.__file__}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    if arch == "rwkv6-3b":
        wt = chip_smoke.wkv6_bwd_times(rand)
        times = {k: v for k, v in wt.items() if k.endswith("_ms")}
        print(f"[train_step_p50] {smi}: device ms a call at (4, 2048, 40, 64) bf16, no state: "
              f"wkv6_bwd {times['wkv6_bwd_ms']:.5f}, the training forward (checkpoints "
              f"{wt['ckpt_bytes'] / 1e6:.1f} MB) {times['wkv6_train_forward_ms']:.5f}, the "
              f"serving forward {times['wkv6_serve_forward_ms']:.5f}", flush=True)
        del wt
    else:
        bt = chip_smoke.backward_times(rand)
        times = {k: v for k, v in bt.items() if k.endswith("_ms")}
        del bt
        print(f"[train_step_p50] {smi}: device ms a call: rmsnorm_bwd "
              f"{times['rmsnorm_bwd_ms']:.5f}, F.rms_norm backward "
              f"{times['rms_norm_backward_ms']:.5f} (x (8192, 2560) bf16); flash_attention_bwd "
              f"{times['flash_attention_bwd_ms']:.5f}, SDPA backward "
              f"{times['sdpa_backward_ms']:.5f}, "
              f"kernel / SDPA {times['flash_attention_bwd_ms'] / times['sdpa_backward_ms']:.3f} "
              "(q (4, 32, 2048, 80) kv (4, 8, 2048, 80) bf16 causal window 4096)", flush=True)
    torch.cuda.empty_cache()
    run = chip_smoke.fit_and_time(arch, dev, card_peaks(torch.cuda.get_device_name(0)))
    buckets = run["buckets"]
    kind = "wkv6 backward" if arch == "rwkv6-3b" else "flash backward"
    total, bwd = sum(buckets.values()), buckets.get(kind, 0.0)
    print(f"[train_step_p50] {smi}: {arch} at full width, batch 4 x 2048: losses "
          f"{', '.join(f'{x:.4f}' for x in run['losses'])}; captures {run['captures']}; "
          f"launches {run['counts']}; replayed step ms "
          f"{', '.join(f'{t:.2f}' for t in run['step_ms'])}; p50 {run['step_p50_ms']:.2f}; "
          f"{run['tokens_per_s']:.0f} tokens/s; MFU {run['mfu']:.4f}; peak "
          f"{run['peak'] / 2**30:.2f} GiB; one replayed step's kernels {total:.2f} ms "
          f"(torch.profiler), the {kind} {bwd:.2f} ({bwd / total:.3f})", flush=True)
    print(json.dumps({"repro_torch": repro_torch.__file__, "card": smi, "arch": arch, **times,
                      "step_ms": run["step_ms"], "step_p50_ms": run["step_p50_ms"],
                      "tokens_per_s": run["tokens_per_s"], "mfu": run["mfu"],
                      "peak_bytes": run["peak"], "profiled_step_ms": total,
                      "backward_kernel_ms": bwd}))


if __name__ == "__main__":
    main()
