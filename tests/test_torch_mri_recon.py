"""The port's SimpleMRIRecon on the CPU against the JAX package's, at the
SMOKE size (2 frames, 3 coils, 24x20), in every mode, in place or not,
with the maps in the k-space arena or joined as their own input.

Tolerance rtol 1e-4 / atol 1e-4: the band ``docs/kernels.md`` gives the
batched and fused modes (the JAX fused kernel does the IFFT as a DFT matmul).
"""
import warnings

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import processes as jproc
import repro_torch.core as tcore
from repro_torch.configs.mri_recon import SMOKE
from repro_torch.core import (CLapp, Data, DeviceTraits, DeviceType, DonatedBufferError,
                              KData, PlatformTraits, PortError, ProcessChain,
                              ProfileParameters, TensorSpec, XData)
from repro_torch.processes import (FFT, ComplexElementProd, FFTParams, FusedMRIRecon,
                                   FusedReconParams, RSSCombine, SimpleMRIRecon, XImageSum)

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = (SMOKE.frames, SMOKE.coils, SMOKE.height, SMOKE.width)
JAX_MODE = {"staged": "staged", "fused": "fused", "fused_kernel": "fused_pallas"}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    f, c, h, w = SHAPE
    k = (rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)
    s = (rng.standard_normal((c, h, w)) + 1j * rng.standard_normal((c, h, w))
         ).astype(np.complex64)
    return k, s


def _cpu_app():
    return CLapp().init(PlatformTraits(), DeviceTraits(type=DeviceType.CPU))


def _wire(core, app, proc, k, s, join):
    """The same user wiring in either package."""
    if join:
        proc.in_handle = app.addData(core.Data({"kdata": k.copy()}))
        proc.in_handles["smaps"] = app.addData(core.Data({"sensitivity_maps": s.copy()}))
    else:
        proc.in_handle = app.addData(core.KData({"kdata": k.copy(),
                                                 "sensitivity_maps": s.copy()}))
    f, _, h, w = k.shape
    proc.out_handle = app.addData(core.XData({"xdata": np.zeros((f, h, w), np.complex64)}))
    return proc.out_handle


def _run_port(mode, in_place, join, k, s, launches=1, use_kernel="auto"):
    app = _cpu_app()
    p = SimpleMRIRecon(app, mode=mode, in_place=in_place, join=join, use_kernel=use_kernel)
    h_out = _wire(tcore, app, p, k, s, join)
    p.init()
    outs = []
    for _ in range(launches):
        p.launch()
        app.device2Host(h_out)
        outs.append(app.getData(h_out).get_ndarray(0).host.copy())
    return outs


_JAX_CACHE = {}


def _run_jax(mode, use_pallas, in_place, join, k, s):
    key = (mode, use_pallas, in_place, join)
    if key not in _JAX_CACHE:
        app = jcore.CLapp().init()
        p = jproc.SimpleMRIRecon(app, mode=JAX_MODE[mode], use_pallas=use_pallas,
                                 in_place=in_place, join=join)
        h_out = _wire(jcore, app, p, k, s, join)
        p.init()
        p.launch()
        app.device2Host(h_out)
        _JAX_CACHE[key] = np.asarray(app.getData(h_out).get_ndarray(0).host).copy()
    return _JAX_CACHE[key]


@pytest.mark.parametrize("join", [False, True])
@pytest.mark.parametrize("in_place", [True, False])
@pytest.mark.parametrize("mode", ["staged", "fused", "fused_kernel"])
def test_simple_mri_recon_matches_jax(inputs, mode, in_place, join):
    k, s = inputs
    (got,) = _run_port(mode, in_place, join, k, s)
    assert got.shape == (SHAPE[0],) + SHAPE[2:] and got.dtype == np.complex64
    for use_pallas in (True, False):
        want = _run_jax(mode, use_pallas, in_place, join, k, s)
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"use_pallas={use_pallas}")


@pytest.mark.parametrize("mode", ["staged", "fused", "fused_kernel"])
def test_second_launch_out_of_place_repeats(inputs, mode):
    k, s = inputs
    first, second = _run_port(mode, False, False, k, s, launches=2)
    np.testing.assert_array_equal(first, second)   # same program, same bytes


@pytest.mark.parametrize("mode", ["staged", "fused"])
def test_reinit_reuses_the_scratch_arena(inputs, mode):
    """``in_place=False`` allocates its scratch KData once: a second
    ``init()`` registers no new Data, and the result is unchanged (exact)."""
    k, s = inputs
    app = _cpu_app()
    p = SimpleMRIRecon(app, mode=mode, in_place=False)
    h_out = _wire(tcore, app, p, k, s, join=False)
    p.init()
    scratch = p._scratch
    registered = len(app._data)
    p.launch()
    app.device2Host(h_out)
    first = app.getData(h_out).get_ndarray(0).host.copy()
    p.init()
    assert (p._scratch, len(app._data)) == (scratch, registered)
    p.launch()
    app.device2Host(h_out)
    np.testing.assert_array_equal(app.getData(h_out).get_ndarray(0).host, first)


def test_rss_combine_matches_jax(inputs):
    k, s = inputs
    x = np.fft.ifft2(k, norm="ortho").astype(np.complex64)
    f, _, h, w = x.shape
    japp = jcore.CLapp().init()
    jp = jproc.RSSCombine(japp)
    jp.in_handle = japp.addData(jcore.Data({"kdata": x}))
    jp.out_handle = japp.addData(jcore.XData({"xdata": np.zeros((f, h, w), np.float32)}))
    jp.init()
    jp.launch()
    japp.device2Host(jp.out_handle)
    want = np.asarray(japp.getData(jp.out_handle).get_ndarray(0).host)

    app = _cpu_app()
    p = RSSCombine(app)
    p.in_handle = app.addData(Data({"kdata": x}))
    p.out_handle = app.addData(XData({"xdata": np.zeros((f, h, w), np.float32)}))
    p.launch()                                  # lazy init, as the reference allows
    app.device2Host(p.out_handle)
    np.testing.assert_allclose(app.getData(p.out_handle).get_ndarray(0).host, want,
                               rtol=2e-6, atol=2e-5)


@pytest.mark.parametrize("combine", ["sum", "rss"])
def test_rss_variants_agree(inputs, combine):
    """§IV-B: the staged FFT > product > RSSCombine chain and FusedMRIRecon
    with combine="rss" give the same image (and "sum" the oracle's)."""
    k, s = inputs
    x = np.fft.ifft2(k.astype(np.complex128), norm="ortho") * np.conj(s)[None]
    want = np.sqrt((np.abs(x) ** 2).sum(1)) if combine == "rss" else x.sum(1)
    app = _cpu_app()
    p = FusedMRIRecon(app)
    p.in_handle = app.addData(KData({"kdata": k, "sensitivity_maps": s}))
    dtype = np.float32 if combine == "rss" else np.complex64
    p.out_handle = app.addData(XData({"xdata": np.zeros(want.shape, dtype)}))
    p.set_launch_parameters(FusedReconParams(combine=combine))
    p.init()
    p.launch()
    app.device2Host(p.out_handle)
    np.testing.assert_allclose(app.getData(p.out_handle).get_ndarray(0).host, want, **TOL)
    if combine == "rss":
        work = app.addData(app.getData(p.in_handle).spec_clone())
        out = app.addData(XData({"xdata": np.zeros(want.shape, np.float32)}))
        fft, prod, rss = FFT(app), ComplexElementProd(app), RSSCombine(app)
        fft.in_handle, fft.out_handle = p.in_handle, work
        fft.set_launch_parameters(FFTParams("backward", var="kdata"))
        prod.in_handle = prod.out_handle = work
        rss.in_handle, rss.out_handle = work, out
        chain = ProcessChain(app, [fft, prod, rss], mode="staged")
        prof = ProfileParameters(enable=True)
        chain.launch(prof)
        assert len(prof.samples) == 1
        app.device2Host(out)
        np.testing.assert_allclose(app.getData(out).get_ndarray(0).host, want, **TOL)


def test_use_kernel_true_on_cpu_raises(inputs):
    k, s = inputs
    with pytest.raises(ValueError, match="CUDA"):
        _run_port("staged", False, False, k, s, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        _run_port("fused_kernel", False, False, k, s, use_kernel=True)


def test_in_place_rewiring_raises_and_join_needs_smaps(inputs):
    k, s = inputs
    app = _cpu_app()
    p = ComplexElementProd(app)
    h = app.addData(KData({"kdata": k, "sensitivity_maps": s}))
    p.in_handle = p.out_handle = h
    p.init()
    p.launch()
    p.out_handle = app.addData(KData({"kdata": k, "sensitivity_maps": s}))
    with pytest.raises(DonatedBufferError):
        p.launch()
    p.init()          # re-init for the new wiring clears it
    p.launch()
    r = SimpleMRIRecon(app, join=True)
    r.in_handle = app.addData(Data({"kdata": k}))
    r.out_handle = app.addData(XData({"xdata": np.zeros((2, 24, 20), np.complex64)}))
    with pytest.raises(PortError):
        r.init()


def test_out_specs_and_legacy_setters(inputs):
    k, s = inputs
    app = _cpu_app()
    specs = KData({"kdata": k, "sensitivity_maps": s}).specs()
    assert SimpleMRIRecon(app).out_specs(specs) == {
        "xdata": TensorSpec((2, 24, 20), np.dtype(np.complex64))}
    p = FusedMRIRecon(app)
    p.set_launch_parameters(FusedReconParams(combine="rss"))
    assert p.out_specs(specs)["xdata"] == TensorSpec((2, 24, 20), np.dtype(np.float32))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p.set_in_handle(0)
        p.set_out_handle(1)
    assert [w.category for w in caught] == [DeprecationWarning]
    assert (p.in_handle, p.out_handle) == (0, 1)


@pytest.mark.parametrize("make", [
    lambda app: ComplexElementProd(app), lambda app: XImageSum(app),
    lambda app: RSSCombine(app), lambda app: FusedMRIRecon(app)],
    ids=["ComplexElementProd", "XImageSum", "RSSCombine", "FusedMRIRecon"])
def test_out_specs_match_what_apply_returns(inputs, make):
    """Each kernel process states its output specs without running; they
    are exactly the shapes and dtypes its ``apply`` gives on the CPU."""
    k, s = inputs
    app = _cpu_app()
    p = make(app)
    views = {"kdata": torch.from_numpy(k.copy()), "sensitivity_maps": torch.from_numpy(s)}
    specs = KData({"kdata": k, "sensitivity_maps": s}).specs()
    got = {n: TensorSpec(tuple(v.shape), np.dtype(str(v.dtype).removeprefix("torch.")))
           for n, v in p.apply(views, {}, None).items()}
    assert p.out_specs(specs) == got


def test_cpu_tensors_stay_on_the_cpu(inputs):
    k, s = inputs
    app = _cpu_app()
    h = app.addData(KData({"kdata": k, "sensitivity_maps": s}))
    assert app.getData(h).device_blob.device == torch.device("cpu")
    assert app.device == torch.device("cpu")
