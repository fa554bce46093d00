"""The port's ``KernelChooser`` (``repro_torch.launch.roofline``) on the CPU.

* ``calibrate`` on CPU tensors gives an untimed ``"plain"`` record, as the
  JAX package's chooser gives an untimed ``"xla"`` record off the TPU
  (``tests/test_kernels.py``'s
  ``test_kernel_chooser_interpret_short_circuit``); both key the record by
  (kernel, layout, device) with the same layout key, and a second call
  returns the same record.  ``"auto"`` follows the device and calibrates
  nothing, in a launch too.
* ``resolve_backend(use_kernel, name, *tensors)`` keeps its forced-choice
  errors; ``calibrate`` raises during a (patched) CUDA-graph capture.
* Each kernel's cost model gives the bound of ``PERF.md`` §6 at the
  table's shapes within 1 % (pure arithmetic on shapes, on ``meta``
  tensors): the larger of bytes at 3.35 TB/s and operations at the rate
  of their type.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import process as jprocess
from repro.launch import roofline as jroofline
from repro.processes import SimpleMRIRecon as JSimpleMRIRecon
import repro_torch.kernels.coil_combine  # noqa: F401  (registers the kernels)
import repro_torch.kernels.complex_elementprod  # noqa: F401
import repro_torch.kernels.flash_attention  # noqa: F401
import repro_torch.kernels.mri_fused  # noqa: F401
import repro_torch.kernels.negate  # noqa: F401
import repro_torch.kernels.rmsnorm  # noqa: F401
import repro_torch.kernels.wkv6  # noqa: F401
import repro_torch.optim.adamw  # noqa: F401
from repro_torch.launch import roofline
from repro_torch.launch.roofline import (CALIBRATION_TIE_BAND, CARD_PEAKS, H100_PEAKS,
                                         KernelChooser, card_peaks, default_chooser,
                                         kernel_cost, resolve_backend, roofline_terms)

C64, BF16, F32 = torch.complex64, torch.bfloat16, torch.float32


@pytest.fixture
def fresh_caches():
    """Both packages' calibration stores empty for the test, then restored."""
    saved_j, saved_t = dict(jprocess._COMPILE_CACHE), dict(roofline._CALIBRATIONS)
    jprocess._COMPILE_CACHE.clear()
    roofline._CALIBRATIONS.clear()
    yield
    jprocess._COMPILE_CACHE.clear()
    jprocess._COMPILE_CACHE.update(saved_j)
    roofline._CALIBRATIONS.clear()
    roofline._CALIBRATIONS.update(saved_t)


def _c64(*shape):
    return np.zeros(shape, np.complex64)


# (name, args, kwargs) at SMOKE-like shapes, as the processes call the kernels
CASES = {
    "xImageSum": (lambda x, s: (x,), {}),
    "rss": (lambda x, s: (x,), {}),
    "complexElementProd": (lambda x, s: (x, s, True), {}),
    "mriFusedRecon": (lambda x, s: (x, s), {"combine": "sum", "norm": "ortho"}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_auto_on_the_cpu_agrees_with_the_jax_chooser_off_tpu(fresh_caches, name):
    make, kw = CASES[name]
    x, s = _c64(2, 3, 8, 8), _c64(3, 8, 8)
    jargs = make(jnp.asarray(x), jnp.asarray(s))
    targs = make(torch.from_numpy(x), torch.from_numpy(s))
    assert jroofline.default_chooser().use_pallas(name, *jargs, **kw) is False
    trec = default_chooser().calibrate(name, *targs, **kw)
    jrec = jroofline.default_chooser().lookup(name, *jargs, **kw)
    assert (jrec.backend, jrec.interpreted) == ("xla", True)
    assert (trec.backend, trec.timed) == ("plain", False)
    assert trec.layout == jrec.layout           # the same (kernel, layout) key
    assert trec.device == "cpu" and not trec.use_kernel
    assert trec.t_kernel_s == trec.t_plain_s == float("inf")
    assert trec.reason == roofline.NO_KERNEL_ON_CPU
    # cached: a second call gives the same record, and "auto" adds none
    tensors = [a for a in targs if isinstance(a, torch.Tensor)]
    assert resolve_backend("auto", name, *tensors) is False
    assert default_chooser().lookup(name, *targs, **kw) is trec
    assert KernelChooser().calibrate(name, *targs, **kw) is trec
    assert [r for r in default_chooser().records() if r.kernel == name] == [trec]
    # another layout is another record
    other = make(torch.from_numpy(_c64(1, 3, 8, 8)), torch.from_numpy(s))
    assert default_chooser().lookup(name, *other, **kw) is None
    assert default_chooser().calibrate(name, *other, **kw) is not trec


def test_a_process_on_the_cpu_calibrates_nothing(fresh_caches):
    """SimpleMRIRecon's fused_kernel launch resolves "auto": the JAX
    package through its chooser (one untimed record), the port by the
    device alone (no record; calibrating is explicit), both the plain
    version, with equal results."""
    from repro import core as jcore
    from repro_torch.core import CLapp, DeviceTraits, DeviceType, KData, XData
    from repro_torch.processes import SimpleMRIRecon

    rng = np.random.default_rng(0)
    k = (rng.standard_normal((2, 3, 8, 8)) + 1j * rng.standard_normal((2, 3, 8, 8))
         ).astype(np.complex64)
    s = (rng.standard_normal((3, 8, 8)) + 1j * rng.standard_normal((3, 8, 8))
         ).astype(np.complex64)
    recs, outs = [], []
    for mod, app, cls, mode in (
            ("port", CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU)),
             SimpleMRIRecon, "fused_kernel"),
            ("jax", jcore.CLapp().init(), JSimpleMRIRecon, "fused_pallas")):
        core = jcore if mod == "jax" else None
        kd = (core.KData if core else KData)({"kdata": k, "sensitivity_maps": s})
        xd = (core.XData if core else XData)({"xdata": np.zeros((2, 8, 8), np.complex64)})
        p = cls(app, mode=mode, in_place=False)
        p.in_handle, p.out_handle = app.addData(kd), app.addData(xd)
        p.init()
        p.launch()
        app.device2Host(p.out_handle)
        outs.append(np.asarray(app.getData(p.out_handle).get_ndarray(0).host))
        chooser = jroofline.default_chooser() if core else default_chooser()
        recs.append([r for r in chooser.records() if r.kernel == "mriFusedRecon"])
    (trec, jrec) = recs
    assert trec == [] and [r.backend for r in jrec] == ["xla"]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)


def test_resolve_backend_keeps_the_forced_choice_errors():
    cpu = torch.zeros(2, 3, 4, 4, dtype=C64)
    assert resolve_backend(False, "xImageSum", cpu) is False
    with pytest.raises(ValueError, match=r"kernels \(xImageSum\) run only on CUDA tensors"):
        resolve_backend(True, "xImageSum", cpu)
    with pytest.raises(ValueError, match="expected True, False or 'auto'"):
        resolve_backend("sometimes", "xImageSum", cpu)
    with pytest.raises(ValueError, match="mixed or unsupported devices"):
        resolve_backend("auto", "complexElementProd", cpu, torch.zeros(4, 4, device="meta"))
    meta = torch.zeros(2, 3, 4, 4, dtype=C64, device="meta")
    for choice in (True, False, "auto"):        # shape inference: the plain version
        assert resolve_backend(choice, "xImageSum", meta) is False


def test_calibrate_raises_during_a_capture(fresh_caches, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="during a CUDA-graph capture"):
        KernelChooser().calibrate("rss", torch.zeros(1, 2, 4, 4, dtype=C64))
    assert roofline._CALIBRATIONS == {}


def test_calibrate_on_the_cpu_is_untimed(fresh_caches, monkeypatch):
    """The port has no interpret mode, so a CPU calibration times nothing:
    neither the kernel nor its plain version runs."""
    entry = roofline.registry.KernelRegistry().entry("rss")
    monkeypatch.setattr(entry, "ref", lambda *a, **k: pytest.fail("plain version timed"))
    monkeypatch.setattr(entry, "fn", lambda *a, **k: pytest.fail("kernel timed"))
    x = torch.zeros(1, 2, 8, 8, dtype=C64)
    rec = KernelChooser(reps=2).calibrate("rss", x)
    assert (rec.backend, rec.timed, rec.device) == ("plain", False, "cpu")
    assert rec.t_kernel_s == rec.t_plain_s == float("inf")
    assert (rec.t_compute_est_s, rec.t_memory_est_s) == (0.0, 0.0)
    assert 0 < CALIBRATION_TIE_BAND < 1


def _meta(*shape, dtype=C64):
    return torch.empty(shape, dtype=dtype, device="meta")


CFG = (16, 8, 160, 160)


def _mri(name, **kw):
    f, c, h, w = CFG
    k, s = _meta(*CFG), _meta(c, h, w)
    args = {"complexElementProd": (k, s, True), "xImageSum": (k,), "rss": (k,),
            "mriFusedEpilogue": (k, s), "mriFusedRecon": (k, s)}[name]
    return name, args, kw


#: PERF.md §6's bound column (ms) and its bounding term; negate's 0.00016
#: is 0.0001565 rounded to the table's five places; dft_recon's is that of
#: the function (an FFT's operations), not of the kernel's dense DFT
BOUNDS = {
    "cprod": (_mri("complexElementProd"), 0.01614, "memory"),
    "ximage_sum": (_mri("xImageSum"), 0.00880, "memory"),
    "rss": (_mri("rss"), 0.00831, "memory"),
    "fused_epilogue": (_mri("mriFusedEpilogue"), 0.00929, "memory"),
    "dft_recon": (_mri("mriFusedRecon"), 0.00929, "memory"),
    "rmsnorm": (("rmsnorm", (_meta(1024, 5120, dtype=BF16), _meta(5120, dtype=BF16)), {}),
                0.00626, "memory"),
    "flash_attention qwen3-14b prefill": (
        ("flash_attention", (_meta(1, 40, 1024, 128, dtype=BF16),
                             _meta(1, 8, 1024, 128, dtype=BF16),
                             _meta(1, 8, 1024, 128, dtype=BF16)), {}), 0.01087, "compute"),
    "flash_attention whisper encoder": (
        ("flash_attention", tuple(_meta(1, 20, 1500, 64, dtype=BF16) for _ in range(3)),
         {"causal": False}), 0.01165, "compute"),
    "wkv6": (("wkv6", tuple(_meta(1, 1024, 40, 64, dtype=BF16) for _ in range(3))
              + (_meta(1, 1024, 40, 64, dtype=F32), _meta(40, 64, dtype=F32),
                 _meta(1, 40, 64, 64, dtype=F32)), {}), 0.01272, "compute"),
    "negate": (("negate_kernel", (_meta(256, 256, dtype=F32),), {}), 0.0001565, "memory"),
    # rows 6b and 7b: the backward kernels at the h2o-danube-1.8b training
    # shapes (batch 4 x 2048; a layer's attention, window 4096)
    "rmsnorm_bwd": (("rmsnorm_bwd", (_meta(8192, 2560, dtype=BF16), _meta(2560, dtype=BF16),
                                     _meta(8192, 2560, dtype=BF16)), {}), 0.03756, "memory"),
    "flash_attention_bwd h2o-danube-1.8b": (
        ("flash_attention_bwd", (_meta(4, 32, 2048, 80, dtype=BF16),
                                 _meta(4, 8, 2048, 80, dtype=BF16),
                                 _meta(4, 8, 2048, 80, dtype=BF16),
                                 _meta(4, 32, 2048, 80, dtype=BF16),
                                 _meta(4, 32, 2048, 80, dtype=BF16),
                                 _meta(4, 32, 2048, dtype=F32)), {"window": 4096}),
        0.21724, "compute"),
    # row 8b: the wkv6 gradient at the rwkv6-3b training shape (a layer,
    # batch 4 x 2048, no state)
    "wkv6_bwd rwkv6-3b": (
        ("wkv6_bwd", tuple(_meta(4, 2048, 40, 64, dtype=BF16) for _ in range(3))
         + (_meta(4, 2048, 40, 64, dtype=F32), _meta(40, 64, dtype=F32), None,
            _meta(4, 2048, 40, 64, dtype=BF16)), {}), 0.28609, "compute"),
    # row 9: AdamW's two passes at h2o-danube-1.8b's embedding leaf (32000 x
    # 2560 bf16 parameters): the update (28 bytes an element) and the clip's
    # sum of squares (the bf16 gradient read once)
    "adamw_update h2o-danube-1.8b embedding": (
        ("adamw_update", (_meta(32000, 2560, dtype=BF16), _meta(32000, 2560, dtype=F32),
                          _meta(32000, 2560, dtype=BF16), _meta(32000, 2560, dtype=F32),
                          _meta(32000, 2560, dtype=F32)), {}), 0.68470, "memory"),
    "sum_squares h2o-danube-1.8b embedding": (
        ("sum_squares", ([_meta(32000, 2560, dtype=BF16)],), {}), 0.04891, "memory"),
}


@pytest.mark.parametrize("row", sorted(BOUNDS))
def test_cost_models_reproduce_the_bound_column(row):
    (name, args, kwargs), want_ms, term = BOUNDS[row]
    t_compute, t_memory = roofline_terms(name, *args, **kwargs)
    bound_ms = max(t_compute, t_memory) * 1e3
    assert abs(bound_ms - want_ms) <= 0.01 * want_ms, (row, bound_ms, want_ms)
    assert ("memory" if t_memory >= t_compute else "compute") == term


def test_dft_recon_counts_the_operations_of_an_fft():
    """The recon's cost is what the function needs, an inverse FFT a
    (frame, coil) image (5 N log2 N, N = H W) and the epilogue, far below
    the 8 (H + W) flops an element of the kernel's dense DFT products, and
    it reads no IDFT table; the tables change nothing."""
    name, args, kw = _mri("mriFusedRecon")
    f, c, h, w = CFG
    n = f * c * h * w
    cost = kernel_cost(name, *args, **kw)
    assert cost.flops == pytest.approx(5 * n * np.log2(h * w) + 8 * n, rel=1e-12)
    assert cost.flops < 0.05 * 8 * n * (h + w)
    assert cost.bytes == kernel_cost("mriFusedEpilogue", *args).bytes
    tables = (_meta(h, h), _meta(-(-w // 8), 4, w, 4, dtype=F32))
    assert kernel_cost(name, *args, tables=tables) == cost
    assert cost.peak == "fp32"


def test_card_peaks_by_the_name_the_card_reports():
    assert card_peaks("NVIDIA H100 80GB HBM3") is H100_PEAKS
    assert H100_PEAKS == {"hbm_bytes_s": 3.35e12, "fp32": 67e12, "bf16_tensor": 989e12}
    assert card_peaks("NVIDIA H100 PCIe") is CARD_PEAKS["H100 PCIe"]
    with pytest.raises(KeyError, match="no peak rates known"):
        card_peaks("NVIDIA A100-SXM4-80GB")
    # the rates a bound is taken at: another card's give another bound
    args = (_meta(256, 256, dtype=F32),)
    sxm = roofline_terms("negate_kernel", *args)[1]
    pcie = roofline_terms("negate_kernel", *args, peaks=CARD_PEAKS["H100 PCIe"])[1]
    assert pcie == pytest.approx(sxm * 3.35 / 2.0)
