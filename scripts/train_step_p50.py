"""The backward kernels' device times and the replayed training step's p50
at full width, on the card, measured by ``chip_smoke.py``'s own functions.

    PYTHONPATH=src python3 scripts/train_step_p50.py

``chip_smoke.backward_times``: ``rmsnorm_bwd`` at x (8192, 2560) bf16
beside ``F.rms_norm``'s backward, and ``flash_attention_bwd`` at an
h2o-danube-1.8b layer (q (4, 32, 2048, 80), k and v (4, 8, 2048, 80),
bf16, causal, window 4096) beside SDPA's backward (``enable_gqa``).
``chip_smoke.fit_and_time``: h2o-danube-1.8b at full width (random bf16
weights from seed 0), 6 ``Trainer`` steps at batch 4 x 2048, then 5
replayed steps between CUDA events (p50, tokens/s, MFU at the card's
bf16 tensor rate) and one replayed step under ``torch.profiler``.

The measuring code is this tree's ``chip_smoke.py``; ``repro_torch`` is
whichever comes first on ``PYTHONPATH``, so one call can time two trees
in turn, each in a fresh process, with one definition of each number:
``PYTHONPATH=<tree>/src python3 scripts/train_step_p50.py``.  Its last
line is one JSON object of the numbers.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # chip_smoke.py

import chip_smoke  # noqa: E402


def main() -> None:
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

    bt = chip_smoke.backward_times(rand)
    times = {k: v for k, v in bt.items() if k.endswith("_ms")}
    del bt
    torch.cuda.empty_cache()
    print(f"[train_step_p50] {smi}: device ms a call: rmsnorm_bwd {times['rmsnorm_bwd_ms']:.5f}, "
          f"F.rms_norm backward {times['rms_norm_backward_ms']:.5f} (x (8192, 2560) bf16); "
          f"flash_attention_bwd {times['flash_attention_bwd_ms']:.5f}, SDPA backward "
          f"{times['sdpa_backward_ms']:.5f}, kernel / SDPA "
          f"{times['flash_attention_bwd_ms'] / times['sdpa_backward_ms']:.3f} (q (4, 32, 2048, "
          "80) kv (4, 8, 2048, 80) bf16 causal window 4096)", flush=True)
    run = chip_smoke.fit_and_time("h2o-danube-1.8b", dev, card_peaks(torch.cuda.get_device_name(0)))
    buckets = run["buckets"]
    total, flash_bwd = sum(buckets.values()), buckets.get("flash backward", 0.0)
    print(f"[train_step_p50] {smi}: h2o-danube-1.8b at full width, batch 4 x 2048: losses "
          f"{', '.join(f'{x:.4f}' for x in run['losses'])}; captures {run['captures']}; "
          f"launches {run['counts']}; replayed step ms "
          f"{', '.join(f'{t:.2f}' for t in run['step_ms'])}; p50 {run['step_p50_ms']:.2f}; "
          f"{run['tokens_per_s']:.0f} tokens/s; MFU {run['mfu']:.4f}; one replayed step's "
          f"kernels {total:.2f} ms (torch.profiler), the flash backward {flash_bwd:.2f} "
          f"({flash_bwd / total:.3f})", flush=True)
    print(json.dumps({"repro_torch": repro_torch.__file__, "card": smi, **times,
                      "step_ms": run["step_ms"], "step_p50_ms": run["step_p50_ms"],
                      "tokens_per_s": run["tokens_per_s"], "mfu": run["mfu"],
                      "profiled_step_ms": total, "flash_backward_ms": flash_bwd}))


if __name__ == "__main__":
    main()
