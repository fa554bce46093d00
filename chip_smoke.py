#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   hand-written CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
2. Holds every kernel against its plain PyTorch version on the card, at the
   paper's case-study size (16x8x160x160 complex64), an odd small shape, the
   C=64 wide-W regression shape, and for ``fused_recon`` shapes on both sides
   of its gate; then times kernel, plain version and one library call at the
   case-study size (CUDA events; device times from CUDA-graph replays over
   input copies that exceed L2, so inputs come from DRAM).
3. Drives the main path through the user entry points (``CLapp`` ->
   ``KData``/``XData`` -> ``SimpleMRIRecon`` in modes staged / fused /
   fused_kernel, the §IV-B RSS variants, and a 384x384 matrix outside the
   fused kernel's gate), checks each result against a complex128 numpy
   oracle, and shows through the launch counts that every kernel ran.
4. Ends with a ``{"kernels": [...]}`` line and a
   ``{"ok": true, "device": {...}}`` line.

Any failure exits non-zero.  Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = "src/repro_torch/kernels/csrc/mri_kernels.cu"

# (memory bytes/s, fp32 non-tensor FLOP/s) from NVIDIA's data sheets, by
# the name nvidia-smi reports.  The SXM part reports "H100 80GB HBM3".
CARD_PEAKS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H200": (4.8e12, 67e12),
    "H100": (3.35e12, 67e12),
}


def card_peaks(name: str) -> tuple[float, float]:
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    raise SystemExit(f"chip_smoke: no peak rates known for card {name!r}")


def synthetic_kdata(frames: int, coils: int, h: int, w: int, seed: int = 0):
    """Phantom: moving ellipse + smooth coil sensitivities -> K-space."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    smaps = np.stack([
        np.exp(-(((yy - h * (0.2 + 0.6 * c / max(1, coils - 1))) / h) ** 2
                 + ((xx - w * 0.5) / w) ** 2) * 3.0)
        * np.exp(1j * 2 * np.pi * c / coils)
        for c in range(coils)
    ]).astype(np.complex64)
    frames_img = []
    for f in range(frames):
        cx = w * (0.4 + 0.2 * np.sin(2 * np.pi * f / frames))
        img = ((xx - cx) ** 2 / (0.1 * w) ** 2
               + (yy - h * 0.5) ** 2 / (0.2 * h) ** 2 < 1.0).astype(np.float32)
        img += 0.1 * rng.standard_normal((h, w)).astype(np.float32)
        frames_img.append(img.astype(np.complex64))
    imgs = np.stack(frames_img)
    coil_imgs = imgs[:, None] * smaps[None]
    kdata = np.fft.fft2(coil_imgs, norm="ortho").astype(np.complex64)
    return kdata, smaps


def oracle(kdata: np.ndarray, smaps: np.ndarray, combine: str = "sum") -> np.ndarray:
    x = np.fft.ifft2(kdata.astype(np.complex128), norm="ortho")
    prod = np.conj(smaps.astype(np.complex128))[None] * x
    if combine == "rss":
        return np.sqrt((np.abs(prod) ** 2).sum(axis=1))
    return prod.sum(axis=1)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script runs only on a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.mri_recon import CONFIG
    from repro_torch.core import (CLapp, Data, DeviceTraits, KData, PlatformTraits,
                                  ProcessChain, ProfileParameters, XData)
    from repro_torch.core.registry import launch_counts, reset_launch_counts
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.coil_combine import rss, ximage_sum
    from repro_torch.kernels.complex_elementprod import complex_elementprod
    from repro_torch.kernels.mri_fused import dft_fits, fused_epilogue, fused_recon, idft_tables
    from repro_torch.processes import (FFT, ComplexElementProd, ComplexElementProdParams,
                                       FFTParams, FusedMRIRecon, FusedReconParams,
                                       RSSCombine, SimpleMRIRecon)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 1. the card and the build ------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch.cuda.get_device_name: {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    bw, flops = card_peaks(name)
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.2f} s (nvcc {_build.BUILD_INFO['seconds']:.2f} s, "
          f"cached={_build.BUILD_INFO['cached']}) -> {_build.BUILD_INFO['path']}")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[ptxas] {line.strip()}")

    # -- 2. every kernel against its plain version --------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def crand(*shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)

    cfg = (CONFIG.frames, CONFIG.coils, CONFIG.height, CONFIG.width)
    odd, wide, big = (2, 3, 24, 20), (1, 64, 2, 17000), (8, 16, 384, 384)
    elem_tol, sum_tol, wide_tol, dft_tol = (2e-6, 1e-5), (2e-6, 2e-5), (2e-5, 2e-4), (1e-4, 1e-4)
    max_err: dict = {}

    def check(label, kname, got, want, tol, at_config):
        torch.cuda.synchronize()
        rtol, atol = tol
        err = (got - want).abs()
        bad = err > atol + rtol * want.abs()
        abs_err = float(err.max())
        rel_err = float((err / want.abs().clamp_min(1e-30)).max())
        ok = not bool(bad.any())
        print(f"[check] {label}: max_abs {abs_err:.3e} max_rel {rel_err:.3e} "
              f"(rtol {rtol:g}, atol {atol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: {label} disagrees with its plain version")
        if at_config:
            max_err[kname] = max(max_err.get(kname, 0.0), abs_err)

    for shape, tag in ((cfg, "CONFIG"), (odd, "odd"), (wide, "wide-W")):
        f, c, h, w = shape
        tol = wide_tol if tag == "wide-W" else sum_tol
        a, b = crand(f, c, h, w), crand(c, h, w)
        for conj in (False, True):
            check(f"complex_elementprod conj={conj} {shape}", "complex_elementprod",
                  complex_elementprod(a, b, conj), ref.complex_elementprod(a, b, conj),
                  elem_tol, tag == "CONFIG")
        a_copy = a.clone()  # in place, as on the staged chain's arena
        complex_elementprod(a_copy, b, True, out=a_copy)
        check(f"complex_elementprod in place {shape}", "complex_elementprod",
              a_copy, ref.complex_elementprod(a, b, True), elem_tol, tag == "CONFIG")
        check(f"ximage_sum {shape}", "ximage_sum", ximage_sum(a), ref.ximage_sum(a),
              tol, tag == "CONFIG")
        check(f"rss {shape}", "rss", rss(a), ref.rss(a), tol, tag == "CONFIG")
        for comb in ("sum", "rss"):
            check(f"fused_epilogue {comb} {shape}", "fused_epilogue",
                  fused_epilogue(a, b, comb), ref.mri_fused_epilogue(a, b, comb),
                  tol, tag == "CONFIG")
    same_a, same_b = crand(*odd), crand(*odd)
    check(f"complex_elementprod same-shape {odd}", "complex_elementprod",
          complex_elementprod(same_a, same_b, True),
          ref.complex_elementprod(same_a, same_b, True), elem_tol, False)
    for shape, norms in ((cfg, ("ortho",)), (odd, ("ortho", "backward", "forward")),
                         (big, ("ortho",)), (wide, ("ortho",))):
        f, c, h, w = shape
        k, s = crand(*shape), crand(*shape[1:])
        side = "inside" if dft_fits(f, c, h, w) else "outside"
        for norm in norms:
            for comb in ("sum", "rss"):
                check(f"fused_recon {comb} norm={norm} {shape} ({side} the gate)",
                      "fused_recon", fused_recon(k, s, comb, norm),
                      ref.mri_fused_recon(k, s, comb, norm), dft_tol, shape == cfg)
    if not dft_fits(*cfg) or dft_fits(*big) or dft_fits(*wide):
        raise SystemExit("chip_smoke: fused_recon gate does not split the shapes as planned")
    del a, b, a_copy, k, s

    # -- 3. times at the case-study size -------------------------------------
    def events_ms(run, reps):
        times = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def device_ms(fn, sets, reps=25):
        """Device time of one call: ``fn(*inputs)`` for each input set of
        ``sets`` in turn, captured in one CUDA graph, so no host work sits
        between the calls; median of ``reps`` replays after warm-up,
        divided by the number of calls."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for inputs in sets[:3]:
                fn(*inputs)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for inputs in sets:
                fn(*inputs)
        for _ in range(3):
            graph.replay()
        ms = events_ms(graph.replay, reps) / len(sets)
        del graph
        return ms

    def call_ms(fn, reps=30):
        """One call from the host, host overhead included (median)."""
        for _ in range(5):
            fn()
        return events_ms(fn, reps)

    f, c, h, w = cfg
    hw, n = h * w, f * c * h * w
    x, s = crand(*cfg), crand(c, h, w)
    tables = idft_tables(h, w, "ortho", dev)
    # Cold timing: the calls of one graph walk over enough copies of the
    # inputs that a copy comes round again only after more than three L2s
    # of other traffic, so each call reads its inputs from DRAM, as the
    # DRAM bound assumes.  Warm timing repeats the one input set.
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    in_bytes = (n + c * hw) * 8
    copies = max(2, -(-3 * l2 // in_bytes) + 1)
    cold = [(x, s, tables)] + [(x.clone(), s.clone(), (tables[0].clone(), tables[1].clone()))
                               for _ in range(copies - 1)]
    warm = [(x, s, tables)] * copies
    print(f"[time] L2 {l2 / 2**20:.0f} MiB; cold timing walks {copies} input copies "
          f"of {in_bytes / 1e6:.1f} MB")
    stack_b = n * 8
    timed = {
        "complex_elementprod": (
            lambda x, s, t: complex_elementprod(x, s, True),
            lambda x, s, t: ref.complex_elementprod(x, s, True),
            lambda x, s, t: x * s.conj(),
            stack_b * 2 + c * hw * 8, 6 * n,
            "src/repro/kernels/complex_elementprod.py:60"),
        "ximage_sum": (
            lambda x, s, t: ximage_sum(x), lambda x, s, t: ref.ximage_sum(x),
            lambda x, s, t: x.sum(1),
            stack_b + f * hw * 8, 2 * n, "src/repro/kernels/coil_combine.py:59"),
        "rss": (
            lambda x, s, t: rss(x), lambda x, s, t: ref.rss(x),
            lambda x, s, t: torch.linalg.vector_norm(x, dim=1),
            stack_b + f * hw * 4, 4 * n, "src/repro/kernels/coil_combine.py:59"),
        "fused_epilogue": (
            lambda x, s, t: fused_epilogue(x, s), lambda x, s, t: ref.mri_fused_epilogue(x, s),
            lambda x, s, t: torch.einsum("fchw,chw->fhw", x, s.conj()),
            stack_b + c * hw * 8 + f * hw * 8, 8 * n, "src/repro/kernels/mri_fused.py:104"),
        "fused_recon": (
            lambda x, s, t: fused_recon(x, s, tables=t),
            lambda x, s, t: ref.mri_fused_recon(x, s),
            lambda x, s, t: torch.einsum("fchw,chw->fhw", torch.fft.ifft2(x, norm="ortho"),
                                         s.conj()),
            stack_b + c * hw * 8 + (h * h + w * w) * 8 + f * hw * 8,
            8 * n * (h + w) + 8 * n, "src/repro/kernels/mri_fused.py:194"),
    }
    rows = {}
    for kname, (kern, plain, lib, nbytes, ops, replaces) in timed.items():
        t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
        ms, plain_ms, lib_ms = device_ms(kern, cold), device_ms(plain, cold), device_ms(lib, cold)
        warm_ms, warm_lib = device_ms(kern, warm), device_ms(lib, warm)
        rows[kname] = dict(name=kname, route="cuda", source=SRC, replaces=replaces,
                           ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           library_ms=lib_ms, max_abs_err=max_err[kname])
        print(f"[time] {kname} at {cfg}: cold-L2 device ms: kernel {ms:.5f}, "
              f"plain {plain_ms:.5f}, library {lib_ms:.5f}, bound {rows[kname]['bound_ms']:.5f} "
              f"({rows[kname]['bound_by']}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP); "
              f"warm-L2 device ms: kernel {warm_ms:.5f}, library {warm_lib:.5f}; "
              f"one host call: kernel {call_ms(lambda: kern(x, s, tables)):.5f}, "
              f"library {call_ms(lambda: lib(x, s, tables)):.5f}")
    del x, s, tables, cold, warm

    # -- 4. the main path through the entry points ---------------------------
    kdata, smaps = synthetic_kdata(*cfg)
    want_sum, want_rss = oracle(kdata, smaps), oracle(kdata, smaps, "rss")
    reset_launch_counts()

    def run_phase(label, build, want, expect, launches=20):
        app = CLapp().init(PlatformTraits(), DeviceTraits())
        before = launch_counts()
        t0 = time.perf_counter()
        proc, h_out = build(app)
        proc.init()
        torch.cuda.synchronize()
        init_ms = (time.perf_counter() - t0) * 1e3
        prof = ProfileParameters(enable=True)
        for _ in range(launches):
            proc.launch(prof)
        app.device2Host(h_out)
        got = app.getData(h_out).get_ndarray(0).host
        if got.shape != want.shape or not np.isfinite(got).all():
            raise SystemExit(f"chip_smoke: {label}: bad output {got.shape}")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=label)
        delta = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
        missing = [k for k in expect if delta.get(k, 0) < launches]
        if missing:
            raise SystemExit(f"chip_smoke: {label}: kernels {missing} did not run "
                             f"on every launch (counts {delta})")
        print(f"[path] {label}: init {init_ms:.2f} ms, launch p50 {prof.p50() * 1e3:.4f} ms "
              f"over {launches}, max abs err vs oracle {np.abs(got - want).max():.3e}, "
              f"launches {{{', '.join(f'{k}: {v}' for k, v in delta.items() if v)}}}")

    def recon(mode, in_place=False, k=kdata, sm=smaps):
        def build(app):
            h_in = app.addData(KData({"kdata": k, "sensitivity_maps": sm}))
            h_out = app.addData(XData({"xdata": np.zeros((k.shape[0],) + k.shape[2:],
                                                         np.complex64)}))
            p = SimpleMRIRecon(app, mode=mode, in_place=in_place)
            p.in_handle, p.out_handle = h_in, h_out
            return p, h_out
        return build

    def rss_chain(app):
        h_in = app.addData(KData({"kdata": kdata, "sensitivity_maps": smaps}))
        h_work = app.addData(app.getData(h_in).spec_clone())
        h_out = app.addData(XData({"xdata": np.zeros(want_rss.shape, np.float32)}))
        p_fft, p_prod, p_rss = FFT(app), ComplexElementProd(app), RSSCombine(app)
        p_fft.in_handle, p_fft.out_handle = h_in, h_work
        p_fft.set_launch_parameters(FFTParams("backward", var="kdata"))
        p_prod.in_handle = p_prod.out_handle = h_work
        p_prod.set_launch_parameters(ComplexElementProdParams(conjugate=True))
        p_rss.in_handle, p_rss.out_handle = h_work, h_out
        return ProcessChain(app, [p_fft, p_prod, p_rss], mode="staged"), h_out

    def fused_rss(app):
        h_in = app.addData(KData({"kdata": kdata, "sensitivity_maps": smaps}))
        h_out = app.addData(XData({"xdata": np.zeros(want_rss.shape, np.float32)}))
        p = FusedMRIRecon(app)
        p.in_handle, p.out_handle = h_in, h_out
        p.set_launch_parameters(FusedReconParams(combine="rss"))
        return p, h_out

    run_phase("SimpleMRIRecon staged", recon("staged"), want_sum,
              ["complexElementProd", "xImageSum"])
    run_phase("SimpleMRIRecon fused", recon("fused"), want_sum,
              ["complexElementProd", "xImageSum"])
    run_phase("SimpleMRIRecon fused_kernel", recon("fused_kernel"), want_sum,
              ["mriFusedRecon"])
    run_phase("SimpleMRIRecon staged in_place (listing 6)", recon("staged", True),
              want_sum, ["complexElementProd", "xImageSum"], launches=1)
    run_phase("FFT > ComplexElementProd > RSSCombine (§IV-B)", rss_chain, want_rss,
              ["complexElementProd", "rss"])
    run_phase("FusedMRIRecon combine=rss (§IV-B)", fused_rss, want_rss, ["mriFusedRecon"])
    k_big, s_big = synthetic_kdata(*big, seed=1)
    run_phase(f"SimpleMRIRecon fused_kernel {big} (outside the gate)",
              recon("fused_kernel", k=k_big, sm=s_big), oracle(k_big, s_big),
              ["mriFusedEpilogue"], launches=5)
    counts = launch_counts()
    names = {"complex_elementprod": "complexElementProd", "ximage_sum": "xImageSum",
             "rss": "rss", "fused_epilogue": "mriFusedEpilogue",
             "fused_recon": "mriFusedRecon"}
    idle = [k for k, reg in names.items() if counts.get(reg, 0) == 0]
    if idle:
        raise SystemExit(f"chip_smoke: kernels {idle} never launched on the main path")

    # -- 5. result lines -----------------------------------------------------
    kernels = []
    for kname, reg in names.items():
        row = dict(rows[kname])
        row["launches"] = counts[reg]
        kernels.append({key: row[key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
