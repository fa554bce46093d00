"""A study held on the device, reconstructed again and again: the paper's
own measurement (process launches over data already on the device).

Set-up makes ``stacks`` slice stacks of k-space and their own sensitivity
maps on the device from the seed, binds each stack to its own
``SimpleMRIRecon`` (its in and out handles) and launches each three times:
eager, captured, replayed.  The window launches the stacks in turn,
dispatched ahead, with one synchronise a pass, in a closed loop with one
client.  Afterwards every stack's image, as the last timed launch wrote
it, is held against the plain reference; with a control, the control's
images take the program's place there.

Mix parameters: ``stacks``; the configuration's ``frames``, ``coils``,
``height``, ``width`` and ``mode``.
"""
from __future__ import annotations

import time

import torch

from perfbench.drivers.common import app_for, check, free, peak_bytes, sync
from perfbench.reference import mri_recon


def inputs(cfg: dict, stacks: int, seed: int, device):
    """(k-space (S, F, C, H, W), maps (S, C, H, W)), complex64, of ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f, c, h, w = (cfg[k] for k in ("frames", "coils", "height", "width"))
    k = torch.randn((stacks, f, c, h, w), dtype=torch.complex64, device=device, generator=gen)
    s = torch.randn((stacks, c, h, w), dtype=torch.complex64, device=device, generator=gen)
    return k, s


def run(run) -> dict:
    from repro_torch.core import Data, TensorSpec
    from repro_torch.processes import SimpleMRIRecon

    cfg, dev = run.config, run.device
    n = int(run.mix["stacks"])
    f, c, h, w = (cfg[k] for k in ("frames", "coils", "height", "width"))
    c64 = torch.empty((), dtype=torch.complex64).numpy().dtype
    app = app_for(dev)
    k_all, s_all = inputs(cfg, n, run.seed, dev)
    procs, outs = [], []
    for i in range(n):
        h_in = app.addData(Data.from_specs({"kdata": TensorSpec((f, c, h, w), c64),
                                            "sensitivity_maps": TensorSpec((c, h, w), c64)}))
        d_in = app.getData(h_in)
        d_in.device_view("kdata").copy_(k_all[i])
        d_in.device_view("sensitivity_maps").copy_(s_all[i])
        h_out = app.addData(Data.from_specs({"xdata": TensorSpec((f, h, w), c64)}))
        proc = SimpleMRIRecon(app, mode=cfg.get("mode", "staged"), in_place=False)
        proc.in_handle, proc.out_handle = h_in, h_out
        proc.init()
        procs.append(proc)
        outs.append(h_out)
    del k_all, s_all
    for _ in range(3):                  # eager, captured, replayed
        for proc in procs:
            proc.launch()
    sync(dev)

    t0 = run.open_window()
    launches, untraced_from, untraced_launches = 0, t0, 0
    while True:
        with run.mark("pass"):
            for proc in procs:
                with run.span("launch"):
                    proc.launch()
            sync(dev)
        launches += n
        now = time.perf_counter()
        if run.tracing() and now - t0 >= run.trace_seconds():
            run.stop_trace()
            run.counters["traced_launches"] = launches
            untraced_from, untraced_launches = time.perf_counter(), launches
        if now - t0 >= run.seconds:
            break
    elapsed = run.close_window()
    run.counters["launches"] = launches
    # the part of the window after the trace, where the profiler slows nothing
    run.counters["untraced_launches"] = launches - untraced_launches
    run.counters["untraced_s"] = run.window[1] - untraced_from

    peak = peak_bytes(dev)
    images = torch.stack([app.getData(o).device_view("xdata") for o in outs]).clone()
    del procs, outs, app
    free(dev)
    t_ref = time.perf_counter()
    k_all, s_all = inputs(cfg, n, run.seed, dev)
    want = [mri_recon.recon(k_all[i], s_all[i]) for i in range(n)]
    err = max(mri_recon.rel_err(images[i], want[i]) for i in range(n))
    out = {"metrics": {"recon_frames_per_s": f * launches / elapsed, "setup_s": run.setup_s},
           "attempted": launches, "failed": 0, "memory_peak_bytes": peak,
           "notes": [f"reference {time.perf_counter() - t_ref:.3f} s"]}
    if run.control:
        out["program"] = {"image_rel_err": err}
        err = max(mri_recon.rel_err(mri_recon.recon(k_all[i], s_all[i], run.control), want[i])
                  for i in range(n))
    out["checks"] = [check("image_rel_err", err, run.limits["image_rel_err"])]
    return out
