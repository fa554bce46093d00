"""MRI reconstruction example on the port: the paper's §IV-A / listings 5-6,
file in, file out (the counterpart of the JAX package's
``examples/mri_recon.py``).

    python -m repro_torch.launch.mri_recon [--fused|--kernel] [--pipeline] [--join]
        [--stream N] [--batch K] [--sharded] [--proportional] [--kspace PATH] [--out PATH]
        (with src/ on PYTHONPATH)

Reads multicoil cine k-space and its sensitivity maps from an npz
(``--kspace``; without one, the synthetic 16 frames x 8 coils x 160x160
phantom of §IV-B is written to a temporary npz and read back, so the
default run goes through the file path too), uploads them in one pinned
copy, reconstructs M = sum_i conj(S_i) . IFFT(Y_i) with ``SimpleMRIRecon``
(staged; ``--fused``: the stages back to back; ``--kernel``: the whole
chain as one fused kernel, ``dft_recon_kernel`` on the card), checks the
image against a complex128 numpy oracle at rtol/atol 1e-4, and saves it
in the .mat-analogue container (``outputFrames.npz``, or ``--out``).

``--pipeline`` runs the same reconstruction as the declarative graph
``Pipeline(app) | FFT | ComplexElementProd | XImageSum`` in its three
modes: one launch, then 4 slices streamed and served at batch 2 (stream
== serve bit for bit); ``--join`` as the fan-in graph
``Pipeline.from_graph([fft, prod, comb])`` whose maps are a second input
edge: beside the single-arena graph and the graph with the maps bound
statically, 5 slices with shared maps streamed and served at batch 2 (a
tail runs) bit for bit against the statically bound graph, then per-slice
maps through the ``smaps`` edge, launched and streamed.  The launches are
bit for bit the staged launch's image (within 1e-4 of the fused and
kernel modes').

``--stream N`` reconstructs N independent slices (new k-space and maps
each) through ``SimpleMRIRecon.stream`` at ``--batch K`` (default 4): K
slices a launch, the next batch uploaded from pinned memory while this
one computes; the last slice is held against the sequential ``launch()``
(bit for bit in the kernel mode; within 1e-6 in staged and fused mode,
where cuFFT may pick another algorithm for the batch) and the oracle.
``--sharded`` streams over every lane of the app's mesh (one a selected
card; ``--batch`` a multiple of the lane count), each lane's share through
its own twins and upload queue, and prints each lane's rows and twins;
``--proportional`` (implies ``--sharded``) carves each batch by the lanes'
measured throughput and prints the measured rates and the split vectors.

The app selects the CUDA card unless the caller of :func:`main` hands in
a CPU app (the tests do, at the SMOKE size).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import numpy as np

from repro_torch.configs.mri_recon import CONFIG, MRIReconConfig
from repro_torch.core import (CLapp, Data, KData, NDArray, Pipeline, ProfileParameters,
                              SyncSource, XData)
from repro_torch.data.io import save_any
from repro_torch.processes import (FFT, CombineParams, ComplexElementProd,
                                   ComplexElementProdParams, FFTParams, SimpleMRIRecon,
                                   XImageSum)

TOL = dict(rtol=1e-4, atol=1e-4)


def synthetic_kdata(frames: int, coils: int, h: int, w: int, seed: int = 0):
    """Phantom: moving ellipse + smooth coil sensitivities -> K-space.
    Returns (kdata (F, C, H, W), smaps (C, H, W), images (F, H, W)), complex64."""
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
    return kdata, smaps, imgs


def oracle_recon(kdata: np.ndarray, smaps: np.ndarray, combine: str = "sum") -> np.ndarray:
    """The reconstruction in complex128 numpy: the coil sum (eq. 1) or RSS."""
    x = np.fft.ifft2(kdata.astype(np.complex128), norm="ortho")
    prod = np.conj(smaps.astype(np.complex128))[None] * x
    if combine == "rss":
        return np.sqrt((np.abs(prod) ** 2).sum(axis=1))
    return prod.sum(axis=1)


def _check(got: np.ndarray, want: np.ndarray, exact: bool, what: str) -> float:
    """Bit for bit when ``exact``, else within 1e-4; the max abs difference."""
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    return float(np.abs(got - want).max())


def _fft(app: CLapp):
    return FFT(app).bind(infile="kspace", outfile="xspace",
                         params=FFTParams("backward", var="kdata"))


def _arena_pipe(app: CLapp) -> Pipeline:
    """The single-input graph: the maps ride in the KData arena."""
    return (Pipeline(app) | _fft(app)
            | ComplexElementProd(app).bind(params=ComplexElementProdParams(conjugate=True))
            | XImageSum(app).bind(params=CombineParams()))


def _phases_ms(prof: ProfileParameters) -> str:
    """A profile's phase totals, in ms."""
    return ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in prof.phase_totals().items())


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def _slices(cfg: MRIReconConfig, n: int, seed: int):
    """``n`` synthetic slices: (k-space, maps) pairs, each with its own
    k-space and its own maps (the phantom's turned by a phase a slice)."""
    out = []
    for s in range(n):
        k, sm, _ = synthetic_kdata(cfg.frames, cfg.coils, cfg.height, cfg.width, seed=seed + s)
        out.append((k, (sm * np.exp(0.3j * s)).astype(np.complex64)))
    return out


def pipeline_demo(app: CLapp, kdata: np.ndarray, smaps: np.ndarray, reference: np.ndarray,
                  cfg: MRIReconConfig, exact: bool = True) -> dict:
    """The declarative front end in its three modes: one launch against
    the imperative launch's image (``reference``; bit for bit when
    ``exact``), then 4 slices streamed and served at batch 2, stream ==
    serve bit for bit, each against the oracle."""
    pipe = _arena_pipe(app)
    t0 = time.perf_counter()
    out = pipe.run(KData({"kdata": kdata, "sensitivity_maps": smaps}))
    build_launch_ms = _ms(t0)
    err = _check(out.get_ndarray(0).host, reference, exact, "pipeline launch")
    print(f"[pipeline] {pipe}: build+launch {build_launch_ms:.1f} ms, "
          + ("bit-identical to init()/launch()" if exact
             else "matches the fused/kernel launch within 1e-4"))
    pairs = _slices(cfg, 4, 300)
    slices = [KData({"kdata": k, "sensitivity_maps": sm}) for k, sm in pairs]
    streamed = pipe.run(slices, mode="stream", batch=2)
    prof = ProfileParameters(enable=True)
    served = pipe.run(slices, mode="serve", batch=2, profile=prof)
    oracle_err = 0.0
    for i, (st, sv) in enumerate(zip(streamed, served)):
        np.testing.assert_array_equal(st.get_ndarray(0).host, sv.get_ndarray(0).host,
                                      err_msg=f"stream == serve [{i}]")
        oracle_err = max(oracle_err, _check(st.get_ndarray(0).host,
                                            oracle_recon(*pairs[i]), False, f"stream {i}"))
    print(f"[pipeline] stream == serve for {len(slices)} slices at batch 2; serve p50 "
          f"{prof.p50() * 1e3:.1f} ms / p99 {prof.p99() * 1e3:.1f} ms; max abs err "
          f"vs oracle {oracle_err:.3e}")
    return {"build_launch_ms": build_launch_ms, "exact": exact, "max_abs_diff": err,
            "serve_p50_ms": prof.p50() * 1e3, "serve_p99_ms": prof.p99() * 1e3,
            "stream_max_abs_err": oracle_err}


def join_demo(app: CLapp, kdata: np.ndarray, smaps: np.ndarray, reference: np.ndarray,
              cfg: MRIReconConfig, exact: bool = True) -> dict:
    """Fan-in: the maps as a second input edge (a join), against the
    imperative launch (``reference``), the single-arena graph and the
    graph with the maps bound statically; then per-slice maps, which only
    a join can take, one slice a launch."""
    arena_pipe = _arena_pipe(app)
    fft = _fft(app)
    prod = ComplexElementProd(app).bind(infile="xspace", outfile="weighted", smaps="smaps",
                                        params=ComplexElementProdParams(conjugate=True))
    comb = XImageSum(app).bind(infile="weighted", outfile="image", params=CombineParams())
    join_pipe = Pipeline.from_graph(app, [fft, prod, comb], output="image")
    print(f"[join] input edges: {list(join_pipe.input_edges)}")
    t0 = time.perf_counter()
    out = join_pipe.run({"kspace": Data({"kdata": kdata}),
                         "smaps": Data({"sensitivity_maps": smaps})})
    build_launch_ms = _ms(t0)
    _check(out.get_ndarray(0).host, reference, exact, "joined launch")
    print("[join] launch " + ("bit-identical to init()/launch()" if exact
                              else "matches the fused/kernel launch within 1e-4"))

    # shared maps: the join equals the same port bound statically, bit for bit
    aux_pipe = (Pipeline(app) | _fft(app)
                | ComplexElementProd(app).bind(smaps=Data({"sensitivity_maps": smaps}),
                                               params=ComplexElementProdParams(conjugate=True))
                | XImageSum(app).bind(params=CombineParams()))
    kstack = [Data({"kdata": k}) for k, _ in _slices(cfg, 5, 700)]
    for s, kd in enumerate(kstack):
        want = aux_pipe.run(kd).get_ndarray(0).host.copy()
        got = join_pipe.run({"kspace": kd, "smaps": Data({"sensitivity_maps": smaps.copy()})})
        np.testing.assert_array_equal(got.get_ndarray(0).host, want, err_msg=f"shared {s}")
    print("[join] 5 k-spaces with shared maps bit-identical to the statically bound maps")
    # ... and streamed and served: 5 slices at batch 2, so a tail runs
    shared = [{"kspace": kd, "smaps": Data({"sensitivity_maps": smaps.copy()})}
              for kd in kstack]
    want_stream = aux_pipe.run(kstack, mode="stream", batch=2)
    got_stream = join_pipe.run(shared, mode="stream", batch=2)
    prof = ProfileParameters(enable=True)
    got_serve = join_pipe.run(shared, mode="serve", batch=2, profile=prof)
    for i in range(len(shared)):
        want = want_stream[i].get_ndarray(0).host
        np.testing.assert_array_equal(got_stream[i].get_ndarray(0).host, want,
                                      err_msg=f"stream[{i}]")
        np.testing.assert_array_equal(got_serve[i].get_ndarray(0).host, want,
                                      err_msg=f"serve[{i}]")
    print(f"[join] stream and serve of {len(shared)} slices at batch 2 bit-identical to the "
          f"statically bound maps streamed; serve p50 {prof.p50() * 1e3:.1f} ms / p99 "
          f"{prof.p99() * 1e3:.1f} ms")

    # per-slice maps, each slice against the single-arena graph and the oracle
    err = 0.0
    pairs = _slices(cfg, 4, 800)
    for s, (k, sm) in enumerate(pairs):
        want = arena_pipe.run(KData({"kdata": k, "sensitivity_maps": sm})
                              ).get_ndarray(0).host.copy()
        got = join_pipe.run({"kspace": Data({"kdata": k}),
                             "smaps": Data({"sensitivity_maps": sm})}).get_ndarray(0).host
        np.testing.assert_array_equal(got, want, err_msg=f"per-slice maps {s}")
        err = max(err, _check(got, oracle_recon(k, sm), False, f"per-slice oracle {s}"))
    # ... and streamed: both edges batched, one map set a slice in the kernel
    want_arena = arena_pipe.run([KData({"kdata": k, "sensitivity_maps": sm}) for k, sm in pairs],
                                mode="stream", batch=2)
    got_items = join_pipe.run([{"kspace": Data({"kdata": k}),
                                "smaps": Data({"sensitivity_maps": sm})} for k, sm in pairs],
                              mode="stream", batch=2)
    for i, (k, sm) in enumerate(pairs):
        np.testing.assert_array_equal(got_items[i].get_ndarray(0).host,
                                      want_arena[i].get_ndarray(0).host,
                                      err_msg=f"per-slice maps streamed {i}")
        err = max(err, _check(got_items[i].get_ndarray(0).host, oracle_recon(k, sm), False,
                              f"per-slice streamed oracle {i}"))
    print(f"[join] 4 per-slice map sets through the smaps edge, launched and streamed at "
          f"batch 2, bit-identical to the single-arena graph, max abs err vs oracle {err:.3e}")
    return {"build_launch_ms": build_launch_ms, "exact": exact, "max_abs_err": err,
            "serve_p50_ms": prof.p50() * 1e3, "serve_p99_ms": prof.p99() * 1e3,
            "input_edges": list(join_pipe.input_edges),
            "residency": join_pipe.residency_plan}


def stream_slice_stack(app: CLapp, proc: SimpleMRIRecon, cfg: MRIReconConfig,
                       n_slices: int, batch: int, sharded: bool = False,
                       split: str = "equal") -> dict:
    """``n_slices`` independent slices through ``proc.stream`` at ``batch``,
    twice (the first stream sets up the twins; the second is timed); the
    last one against the sequential ``launch()`` (bit for bit in the kernel
    mode, within 1e-6 where cuFFT transforms the whole batch) and the
    oracle.  ``sharded``/``split`` carve each batch over the mesh's
    lanes."""
    pairs = _slices(cfg, n_slices, 100)
    slices = [KData({"kdata": k, "sensitivity_maps": sm}) for k, sm in pairs]
    walls = []
    prof = ProfileParameters(enable=True)
    for run in range(2):        # the first stream sets up the twins, the second reuses them
        t0 = time.perf_counter()
        outs = proc.stream(slices, batch=batch, sharded=sharded, split=split,
                           profile=prof if run else None)
        out_last = outs[-1].device_view("xdata").cpu().numpy()   # waits for the stream's end
        walls.append(_ms(t0))
    first_ms, stream_ms = walls
    d_in = app.getData(proc.in_handle)
    for dst, src in zip(d_in, slices[-1]):
        dst.set_host(src.host)
    app.host2device(proc.in_handle)
    proc.launch()
    seq = app.getData(proc.out_handle).device_view("xdata").cpu().numpy()
    exact = proc.mode == "fused_kernel"
    if exact:
        np.testing.assert_array_equal(out_last, seq, err_msg="streamed != launch()")
    else:
        np.testing.assert_allclose(out_last, seq, rtol=1e-6, atol=1e-6,
                                   err_msg="streamed vs launch()")
    err = _check(out_last, oracle_recon(*pairs[-1]), False, "streamed oracle")
    target = proc.chain
    lanes = target._lane_twins
    twins = lanes if lanes else target._stream_twins
    tag = "[stream]" if not sharded else f"[stream sharded split={split}]"
    print(f"{tag} {app.device}: {n_slices} slices at batch {batch}: {stream_ms:.1f} ms, "
          f"{stream_ms / n_slices:.2f} ms a slice (the first stream, which sets up the "
          f"twins, {first_ms:.1f} ms); the last slice "
          + ("bit-identical to" if exact else "within 1e-6 of")
          + f" launch(), max abs err vs oracle {err:.3e}; "
          + (f"twins (rows, slot) {sorted(twins)}" if not lanes else
             f"twins a lane {_per_lane(lanes)}")
          + f"; the timed stream's phases: {_phases_ms(prof)}")
    res = {"n": n_slices, "batch": batch, "ms": stream_ms, "ms_per_slice": stream_ms / n_slices,
           "phases_s": prof.phase_totals(),
           "first_ms": first_ms, "exact": exact, "max_abs_err": err,
           "launches": {k: bp.launches for k, bp in twins.items()}}
    if lanes:
        vectors = getattr(target, "split_vectors", [])
        rows = [sum(v[j] for v in vectors) for j in range(len(app.mesh.groups))]
        res.update(vectors=vectors, lane_rows=rows, lane_twins=_per_lane(lanes))
        print(f"{tag} mesh {app.mesh.shape}: rows a lane over the timed stream {rows}; "
              f"split vectors {vectors}")
        if split == "proportional":
            lanes_idx = range(len(app.mesh.groups))
            rates = app.device_profiles.rates(lanes_idx)
            res["rates"] = rates
            print(f"{tag} measured lane rates (items/s): "
                  + ", ".join(f"{r:.0f}" for r in rates)
                  + f"; next split of a full batch: {app.device_profiles.split(batch, lanes_idx)}")
    return res


def _per_lane(lane_twins: dict) -> dict:
    """The number of twins of each lane (by its position in the mesh)."""
    out: dict = {}
    for (key, _, _) in lane_twins:
        out[key[0]] = out.get(key[0], 0) + 1
    return dict(sorted(out.items()))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.mri_recon",
                                 description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fused", action="store_true", help="stages back to back")
    mode.add_argument("--kernel", action="store_true",
                      help="the whole chain as one fused kernel (mode fused_kernel)")
    ap.add_argument("--pipeline", action="store_true", help="the declarative graph too")
    ap.add_argument("--join", action="store_true", help="the fan-in graph too")
    ap.add_argument("--stream", type=int, default=0, metavar="N",
                    help="stream N independent slices too")
    ap.add_argument("--batch", type=int, default=4, metavar="K",
                    help="slices a streamed launch (default 4)")
    ap.add_argument("--sharded", action="store_true",
                    help="stream over every lane of the app's mesh (the selected cards)")
    ap.add_argument("--proportional", action="store_true",
                    help="carve each streamed batch by the lanes' measured throughput "
                         "(implies --sharded)")
    ap.add_argument("--kspace", help="npz with 'kdata' and 'sensitivity_maps' "
                                     "(default: the synthetic phantom, through a file)")
    ap.add_argument("--out", default="outputFrames.npz", help="where the image is saved")
    return ap


def main(argv: Optional[list] = None, app: Optional[CLapp] = None,
         cfg: MRIReconConfig = CONFIG) -> dict:
    """The example; returns its timings (wall ms) and checks.  ``app``
    (default: the CUDA card) and ``cfg`` (the synthetic phantom's size)
    are for callers in Python."""
    args = _parser().parse_args(argv)
    mode = "fused_kernel" if args.kernel else "fused" if args.fused else "staged"
    if app is None:
        app = CLapp().init()
    app.loadKernels(["complex_elementprod", "coil_combine"])
    res = {"device": str(app.device), "mode": mode}
    with tempfile.TemporaryDirectory() as tmp:
        path = args.kspace
        if path is None:
            kdata, smaps, _ = synthetic_kdata(cfg.frames, cfg.coils, cfg.height, cfg.width)
            path = os.path.join(tmp, "kspace.npz")
            save_any(path, {KData.KDATA: kdata, KData.SMAPS: smaps})
        t0 = time.perf_counter()
        data_in = KData(path, variables=[KData.KDATA, KData.SMAPS])
        res["load_ms"] = _ms(t0)
    kdata, smaps = data_in.kdata.host, data_in.smaps.host
    data_out = XData([NDArray(shape=data_in.x_shape(), dtype=kdata.dtype, name="xdata")])

    t0 = time.perf_counter()
    h_in = app.addData(data_in)              # one pinned upload
    app.wait_transfers()
    res["upload_ms"] = _ms(t0)
    h_out = app.addData(data_out)            # zeroed on the device, nothing uploaded
    proc = SimpleMRIRecon(app, mode=mode)
    proc.in_handle, proc.out_handle = h_in, h_out
    t0 = time.perf_counter()
    proc.init()
    res["init_ms"] = _ms(t0)
    prof = ProfileParameters(enable=True)
    t0 = time.perf_counter()
    proc.launch(prof)                        # the profile waits for the launch's end
    res["launch_ms"] = _ms(t0)
    res["launch_device_ms"] = prof.samples[-1] * 1e3
    res["launch_phases_s"] = prof.phase_totals()
    t0 = time.perf_counter()
    app.device2Host(h_out)
    res["d2h_ms"] = _ms(t0)
    print(f"[{mode}] {app.device}: load {res['load_ms']:.2f} ms, upload "
          f"{res['upload_ms']:.2f} ms, init {res['init_ms']:.1f} ms, launch "
          f"{res['launch_ms']:.3f} ms ({_phases_ms(prof)}), device to host "
          f"{res['d2h_ms']:.2f} ms")
    recon = data_out.get_ndarray(0).host
    res["max_abs_err"] = _check(recon, oracle_recon(kdata, smaps), False, "oracle")
    print("reconstruction verified against the numpy oracle")
    out_path = args.out if args.out.endswith(".npz") else args.out + ".npz"
    t0 = time.perf_counter()
    data_out.matlab_save(out_path, "XData", SyncSource.HOST_ONLY)
    res["save_ms"], res["out_path"] = _ms(t0), out_path
    print(f"saved {out_path}")

    exact = mode == "staged"
    if args.pipeline:
        res["pipeline"] = pipeline_demo(app, kdata, smaps, recon, cfg, exact)
    if args.join:
        res["join"] = join_demo(app, kdata, smaps, recon, cfg, exact)
    if args.stream:
        res["stream"] = stream_slice_stack(
            app, proc, cfg, args.stream, args.batch, sharded=args.sharded or args.proportional,
            split="proportional" if args.proportional else "equal")
    return res


if __name__ == "__main__":
    main()
