#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   hand-written CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all started together).
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
4. Holds the LM kernels (``rmsnorm``, ``flash_attention``) against their
   plain versions on the card (bf16 at rtol/atol 2e-2, f32 at rtol 1e-4 /
   atol 1e-5) at the qwen3-14b serving shapes and at odd ones, and times
   them at the prefill shapes beside ``F.rms_norm`` and
   ``F.scaled_dot_product_attention`` (yardsticks only).
5. Serves qwen3-14b at full width (random bf16 weights made on the card
   from a seed) through ``LMServer``: 10 requests of 17-1024 prompt tokens,
   4 slots, 32 new tokens each; checks the tokens, that both kernels ran
   on every prefill and step, and that the decode state never moved host
   to device.  Then runs the first 2 layers of the same weights once on the
   card and once on a CPU app in f32, and compares the logits.
6. Ends with a ``{"kernels": [...]}`` line and a
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
LM_SRC = "src/repro_torch/kernels/csrc/lm_kernels.cu"

# (memory bytes/s, fp32 non-tensor FLOP/s, bf16 dense tensor FLOP/s) from
# NVIDIA's data sheets, by the name nvidia-smi reports.  The SXM part
# reports "H100 80GB HBM3".  The MRI kernels are bound by the fp32 rate,
# the LM kernels by the bf16 tensor rate.
CARD_PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H200": (4.8e12, 67e12, 989e12),
    "H100": (3.35e12, 67e12, 989e12),
}


def card_peaks(name: str) -> tuple[float, float, float]:
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


def visible_pairs(sq: int, skv: int, causal: bool, window: int | None) -> int:
    """Query-key pairs attention computes: each query i (at position
    i + skv - sq) sees keys up to itself (causal) and above its window."""
    qpos = np.arange(sq) + skv - sq
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def main() -> None:
    import torch
    import torch.nn.functional as F

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
    bw, flops, bf16_flops = card_peaks(name)
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

    # -- 5. LM kernels against their plain versions ---------------------------
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.processes.lm import weights_data
    from repro_torch.serve import LMServer, SamplingConfig

    bf16, f32 = torch.bfloat16, torch.float32
    lm_tol = {bf16: (2e-2, 2e-2), f32: (1e-4, 1e-5)}   # (rtol, atol); bf16: one
    # rounding of the output plus another order of sums

    def rand(*shape, dtype=f32):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    for shape, dtype, on_path in (((1024, 5120), bf16, True), ((4, 5120), bf16, True),
                                  ((1 * 40 * 1024, 128), bf16, True), ((21, 80), f32, False)):
        x, w = rand(*shape, dtype=dtype), rand(shape[-1], dtype=dtype)
        check(f"rmsnorm {shape} {dtype}", "rmsnorm", rmsnorm(x, w).float(),
              ref.rmsnorm(x, w).float(), lm_tol[dtype], on_path)
    flash_cases = (  # q shape, kv shape, causal, window, dtype, on the path
        ((1, 40, 1024, 128), (1, 8, 1024, 128), True, None, bf16, True),  # qwen3-14b prefill
        ((4, 40, 512, 128), (4, 8, 512, 128), True, None, bf16, True),
        ((2, 6, 37, 80), (2, 2, 53, 80), True, 16, bf16, False),  # ragged, window
        ((2, 8, 100, 64), (2, 2, 100, 64), False, None, bf16, False),
        ((2, 8, 1, 128), (2, 8, 300, 128), True, None, bf16, False),  # one query
        ((2, 8, 70, 128), (2, 4, 90, 128), True, 33, f32, False))
    for qs, ks, causal, window, dtype, on_path in flash_cases:
        q, k, v = rand(*qs, dtype=dtype), rand(*ks, dtype=dtype), rand(*ks, dtype=dtype)
        check(f"flash_attention q{qs} kv{ks} causal={causal} window={window} {dtype}",
              "flash_attention",
              flash_attention(q, k, v, causal=causal, window=window).float(),
              ref.attention(q, k, v, causal=causal, window=window).float(),
              lm_tol[dtype], on_path)
    del x, w, q, k, v

    # -- 6. LM kernel times at the qwen3-14b prefill shapes (S = 1024) --------
    def cold_and_warm(make):
        first = make()
        nbytes = sum(t.numel() * t.element_size() for t in first)
        copies = max(2, -(-3 * l2 // nbytes) + 1)
        return [first] + [make() for _ in range(copies - 1)], [first] * copies

    seq = 1024
    lm_timed = {
        "rmsnorm": (
            lambda: (rand(seq, 5120, dtype=bf16), rand(5120, dtype=bf16)),
            lambda x, w: rmsnorm(x, w), lambda x, w: ref.rmsnorm(x, w),
            lambda x, w: F.rms_norm(x, (5120,), w, 1e-6),
            2 * seq * 5120 * 2 + 5120 * 2, 4 * seq * 5120,
            "src/repro/kernels/rmsnorm.py:40", f"x ({seq}, 5120) bf16"),
        "flash_attention": (
            lambda: (rand(1, 40, seq, 128, dtype=bf16), rand(1, 8, seq, 128, dtype=bf16),
                     rand(1, 8, seq, 128, dtype=bf16)),
            lambda q, k, v: flash_attention(q, k, v),
            lambda q, k, v: ref.attention(q, k, v),
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                           enable_gqa=True),
            2 * (40 + 8) * seq * 128 * 2, 4 * 40 * 128 * visible_pairs(seq, seq, True, None),
            "src/repro/kernels/flash_attention.py:124", f"q (1, 40, {seq}, 128) kv (1, 8, {seq}, 128) bf16 causal"),
    }
    for kname, (make, kern, plain, lib, nbytes, ops, replaces, at) in lm_timed.items():
        cold, warm = cold_and_warm(make)
        t_bytes, t_ops = nbytes / bw * 1e3, ops / bf16_flops * 1e3
        ms, plain_ms, lib_ms = device_ms(kern, cold), device_ms(plain, cold), device_ms(lib, cold)
        warm_ms, warm_lib = device_ms(kern, warm), device_ms(lib, warm)
        rows[kname] = dict(name=kname, route="cuda", source=LM_SRC, replaces=replaces,
                           ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           library_ms=lib_ms, max_abs_err=max_err[kname])
        print(f"[time] {kname} at {at}: cold-L2 device ms ({len(cold)} input copies): "
              f"kernel {ms:.5f}, plain {plain_ms:.5f}, library {lib_ms:.5f}, "
              f"bound {rows[kname]['bound_ms']:.5f} ({rows[kname]['bound_by']}: "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP at the bf16 tensor rate); "
              f"warm-L2 device ms: kernel {warm_ms:.5f}, library {warm_lib:.5f}; "
              f"one host call: kernel {call_ms(lambda: kern(*cold[0])):.5f}, "
              f"library {call_ms(lambda: lib(*cold[0])):.5f}")
        del cold, warm
    torch.cuda.empty_cache()

    # -- 7. the LM serving path at full width ---------------------------------
    cfg_lm = get_config("qwen3-14b")
    model = build_model(cfg_lm)
    app = CLapp().init(PlatformTraits(), DeviceTraits())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    weights, wcodec = weights_data(model.param_specs())
    app.addData(weights)
    params = model.init_params(torch.Generator(device=app.device).manual_seed(0),
                               out=wcodec.unflatten(weights.device_views()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(int(np.prod(e.shape)) for e in weights.layout.entries)
    print(f"[lm] qwen3-14b weights: {n_params} parameters, "
          f"{weights.layout.total_bytes / 1e9:.3f} GB bf16 arena, made on the card from "
          f"seed 0 in {init_s:.3f} s")
    server = LMServer(model, weights, batch=4, max_len=2048,
                      sampling=SamplingConfig(max_new_tokens=32), app=app)
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(17, 1025, size=10)]
    for n in lengths:
        server.submit(rng.integers(0, cfg_lm.vocab, n).tolist())
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = server.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    lm_counts = launch_counts()
    bad = [i for i, r in enumerate(results)
           if len(r) != 32 or not all(0 <= t < cfg_lm.vocab for t in r)]
    if len(results) != len(lengths) or bad:
        raise SystemExit(f"chip_smoke: LMServer requests {bad} did not get 32 tokens in "
                         f"[0, {cfg_lm.vocab})")
    forwards = server.admitted + server.steps
    want_counts = {"rmsnorm": (4 * cfg_lm.n_layers + 1) * forwards,
                   "flash_attention": cfg_lm.n_layers * server.admitted}
    if any(lm_counts[k] != n for k, n in want_counts.items()):
        raise SystemExit(f"chip_smoke: LM kernels did not run on every prefill and step: "
                         f"launches {lm_counts}, expected {want_counts}")
    state_h2d = app.h2d_bytes.get(server.state_h, 0)
    if state_h2d or server.decode_profile.phase_total("transfer"):
        raise SystemExit(f"chip_smoke: the decode state moved {state_h2d} bytes host to device")
    n_tokens = sum(len(r) for r in results)
    prefill_ms = [t * 1e3 for t in server.prefill_profile.samples]
    decode_ms = [t * 1e3 for t in server.decode_profile.samples]
    print(f"[lm] {smi}: LMServer qwen3-14b, 10 requests (prompt lengths {lengths}), 4 slots, "
          f"max_len 2048: {n_tokens} tokens in {run_s:.3f} s = {n_tokens / run_s:.2f} tokens/s; "
          f"{server.admitted} prefills, {server.steps} decode steps")
    print(f"[lm] prefill ms per prompt (length: ms): "
          f"{', '.join(f'{n}: {t:.2f}' for n, t in zip(lengths, prefill_ms))}; "
          f"mean {statistics.mean(prefill_ms):.2f}")
    print(f"[lm] decode ms per step: p50 {statistics.median(decode_ms):.3f}, "
          f"mean {statistics.mean(decode_ms):.3f}, min {min(decode_ms):.3f}, "
          f"max {max(decode_ms):.3f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {lm_counts['rmsnorm']} "
          f"rmsnorm, {lm_counts['flash_attention']} flash_attention; decode state h2d bytes "
          f"{state_h2d}")

    # -- 8. whole model, 2 layers at full width: card (kernels) vs CPU (plain,
    # f32).  bf16 activations are rounded at every layer boundary on the
    # card, so the logits agree to a share of their scale, not elementwise:
    # max |card - cpu| <= 2e-2 * max |cpu logit|.
    two = cfg_lm.scaled(n_layers=2)
    p_card = {"embed": params["embed"], "final_norm": params["final_norm"],
              "layers": tree_map(lambda a: a[:2], params["layers"])}
    p_cpu = tree_map(lambda a: a.cpu().float(), p_card)
    m_card, m_cpu = build_model(two), build_model(two.scaled(param_dtype="float32",
                                                             dtype="float32"))
    toks = torch.from_numpy(rng.integers(0, cfg_lm.vocab, (1, 64)))
    c_card, c_cpu = m_card.init_cache(1, 128, device=dev), m_cpu.init_cache(1, 128)

    def compare(label, got, want):
        err = float((got.float().cpu() - want).abs().max())
        limit = 2e-2 * float(want.abs().max())
        print(f"[lm-check] {label}: max |card - cpu| {err:.4e}, limit {limit:.4e} "
              f"{'ok' if err <= limit else 'FAIL'}")
        if not err <= limit or not bool(torch.isfinite(got).all()):
            raise SystemExit(f"chip_smoke: 2-layer qwen3-14b {label} disagrees with the CPU")

    lg, c_card = m_card.prefill(p_card, toks.to(dev), c_card)
    lc, c_cpu = m_cpu.prefill(p_cpu, toks, c_cpu)
    compare("prefill last-token logits", lg, lc)
    for i in range(4):
        tok = lc.argmax(dim=-1).to(torch.int32)           # teacher-forced: both sides
        lg, c_card = m_card.decode_step(p_card, tok.to(dev),
                                        torch.tensor(64 + i, dtype=torch.int32, device=dev), c_card)
        lc, c_cpu = m_cpu.decode_step(p_cpu, tok, 64 + i, c_cpu)
        compare(f"decode step {i} logits", lg, lc)

    # -- 9. result lines -----------------------------------------------------
    kernels = []
    for kname, reg in list(names.items()) + [("rmsnorm", "rmsnorm"),
                                             ("flash_attention", "flash_attention")]:
        row = dict(rows[kname])
        row["launches"] = (lm_counts if kname in lm_timed else counts)[reg]
        kernels.append({key: row[key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
