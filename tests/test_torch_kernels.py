"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels, run as ``tests/test_kernels.py`` runs them
(interpret mode off the TPU).

Tolerances: rtol 2e-6 / atol 1e-5 for the elementwise product and
rtol 2e-6 / atol 2e-5 for the coil sums, as in ``test_kernels.py``; 1e-4 for
the whole-chain reconstruction, whose JAX kernel does the IFFT as a DFT
matmul in another summation order than the FFT.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.coil_combine import rss as j_rss, ximage_sum as j_ximage_sum
from repro.kernels.complex_elementprod import complex_elementprod as j_cprod
from repro.kernels.mri_fused import (_dft_fits as j_dft_fits, _idft_matrix as j_idft_matrix,
                                     fused_epilogue as j_epilogue, fused_recon as j_recon)
from repro_torch.core.registry import KernelRegistry, launch_counts
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.coil_combine import rss, ximage_sum
from repro_torch.kernels.complex_elementprod import complex_elementprod, map_sets
from repro_torch.kernels.mri_fused import (_check_pair, dft_fits, fused_epilogue, fused_recon,
                                           idft_matrix)
from repro_torch.launch.roofline import resolve_backend

ELEM = dict(rtol=2e-6, atol=1e-5)
SUM = dict(rtol=2e-6, atol=2e-5)
DFT = dict(rtol=1e-4, atol=1e-4)


def _c(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("fcwh", [(2, 3, 24, 20), (1, 1, 8, 8)])
@pytest.mark.parametrize("conj", [False, True])
def test_complex_elementprod_broadcast(rng, fcwh, conj):
    f, c, h, w = fcwh
    a, b = _c(rng, fcwh), _c(rng, (c, h, w))
    want = np.asarray(j_cprod(jnp.asarray(a), jnp.asarray(b), conj))
    np.testing.assert_allclose(complex_elementprod(_t(a), _t(b), conj).numpy(), want, **ELEM)


def test_complex_elementprod_same_shape_and_in_place(rng):
    a, b = _c(rng, (4, 6, 6)), _c(rng, (4, 6, 6))
    want = np.asarray(j_cprod(jnp.asarray(a), jnp.asarray(b), True))
    np.testing.assert_allclose(complex_elementprod(_t(a), _t(b), True).numpy(), want, **ELEM)
    ta = _t(a.copy())
    assert complex_elementprod(ta, _t(b), True, out=ta) is ta
    np.testing.assert_allclose(ta.numpy(), want, **ELEM)
    with pytest.raises(ValueError):
        complex_elementprod(_t(a), _t(b[:2]))


@pytest.mark.parametrize("fcwh", [(2, 3, 24, 20), (3, 4, 33, 17)])
def test_coil_combine(rng, fcwh):
    x = _c(rng, fcwh)
    np.testing.assert_allclose(ximage_sum(_t(x)).numpy(),
                               np.asarray(j_ximage_sum(jnp.asarray(x))), **SUM)
    got = rss(_t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j_rss(jnp.asarray(x))), **SUM)


def test_coil_combine_wide_w_c64(rng):
    """The C=64, W=17000 regression shape of test_kernels.py, against the
    JAX plain version (its Pallas run is the reference's own test)."""
    x = _c(rng, (1, 64, 2, 17000))
    tol = dict(rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(ximage_sum(_t(x)).numpy(),
                               np.asarray(jref.ximage_sum(jnp.asarray(x))), **tol)
    np.testing.assert_allclose(rss(_t(x)).numpy(),
                               np.asarray(jref.rss(jnp.asarray(x))), **tol)


@pytest.mark.parametrize("combine", ["sum", "rss"])
def test_fused_epilogue(rng, combine):
    x, s = _c(rng, (2, 3, 24, 20)), _c(rng, (3, 24, 20))
    want = np.asarray(j_epilogue(jnp.asarray(x), jnp.asarray(s), combine=combine))
    np.testing.assert_allclose(fused_epilogue(_t(x), _t(s), combine).numpy(), want, **SUM)


@pytest.mark.parametrize("fcwh", [(2, 3, 24, 20), (1, 1, 8, 264)])
@pytest.mark.parametrize("norm", ["ortho", "backward", "forward"])
@pytest.mark.parametrize("combine", ["sum", "rss"])
def test_fused_recon_both_sides_of_the_jax_gate(rng, fcwh, norm, combine):
    f, c, h, w = fcwh
    assert j_dft_fits(c, h, w) == (w <= 256)   # the two shapes straddle the gate
    k, s = _c(rng, fcwh), _c(rng, (c, h, w))
    want = np.asarray(j_recon(jnp.asarray(k), jnp.asarray(s), combine=combine, norm=norm))
    got = fused_recon(_t(k), _t(s), combine, norm).numpy()
    scale = 1.0 if norm != "forward" else 1.0 / np.sqrt(h * w)  # forward: no 1/n
    np.testing.assert_allclose(got * scale, want * scale, **DFT)


@pytest.mark.parametrize("n", [1, 7, 20, 160])
@pytest.mark.parametrize("norm", ["ortho", "backward", "forward"])
def test_idft_tables_match_reference(n, norm):
    mr, mi = j_idft_matrix(n, norm)
    m = idft_matrix(n, norm)
    assert m.dtype == np.complex64
    np.testing.assert_array_equal(m.real, np.asarray(mr))   # same f32 cast
    np.testing.assert_array_equal(m.imag, np.asarray(mi))
    np.testing.assert_array_equal(m, m.T)                   # the kernel relies on it


def test_dft_gate_from_card_limits():
    assert dft_fits(16, 8, 160, 160)
    assert not dft_fits(8, 16, 384, 384)            # H, W > 256
    assert not dft_fits(1, 64, 2, 17000)
    assert dft_fits(65535, 117, 256, 256)           # every edge; smem has no coil term
    assert not dft_fits(1, 117, 256, 257)           # W one past the 8 warps' tiles
    assert not dft_fits(65536, 1, 8, 8)             # frames ride on gridDim.y


def test_registry_names_and_cpu_runs_count_no_launch(rng):
    reg = KernelRegistry()
    names = reg.load(["complex_elementprod", "coil_combine", "mri_fused"])
    assert sorted(names) == ["complexElementProd", "mriFusedEpilogue", "mriFusedRecon",
                             "rss", "xImageSum"]
    assert reg.get("xImageSum") is ops.ximage_sum
    assert reg.ref("mriFusedRecon") is ref.mri_fused_recon
    before = launch_counts()
    x = _t(_c(rng, (1, 2, 4, 4)))
    reg.get("xImageSum")(x)
    reg.get("mriFusedRecon")(x, x[0])
    assert launch_counts() == before     # plain versions are no launches


def test_wrappers_raise_off_cpu_and_cuda(rng, monkeypatch):
    """A wrapper runs its plain version only for CPU tensors: on ``meta``
    tensors (a dry run's trace) it gives outputs of the plain version's
    layout without running it, and counts no launch."""
    def plain(*_a, **_k):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(ref, "ximage_sum", plain)
    monkeypatch.setattr(ref, "complex_elementprod", plain)
    m = torch.empty((2, 3, 4, 4), dtype=torch.complex64, device="meta")
    before = launch_counts()
    out = ximage_sum(m)
    assert (out.device.type, tuple(out.shape), out.dtype) == ("meta", (2, 4, 4), torch.complex64)
    out = complex_elementprod(m, m[0])
    assert (out.device.type, tuple(out.shape), out.dtype) == ("meta", (2, 3, 4, 4),
                                                              torch.complex64)
    assert launch_counts() == before


def test_resolve_backend_contract():
    cpu = torch.zeros(2, dtype=torch.complex64)
    assert resolve_backend("auto", "xImageSum", cpu) is False
    assert resolve_backend(False, "xImageSum", cpu) is False
    with pytest.raises(ValueError, match="CUDA"):
        resolve_backend(True, "xImageSum", cpu)
    assert resolve_backend(True, "xImageSum", torch.zeros(2, device="meta")) is False
    with pytest.raises(ValueError):
        resolve_backend("sometimes", "xImageSum", cpu)


# ---------------------------------------------------------------------------
# the batched maps form: a stream's batch (B, F, C, H, W), a map set a slice
# ---------------------------------------------------------------------------

BATCHED = (3, 2, 3, 24, 20)        # B, F, C, H, W


def _batch(rng, shape=BATCHED):
    b, f, c, h, w = shape
    return _c(rng, shape), _c(rng, (b, c, h, w))


@pytest.mark.parametrize("conj", [False, True])
def test_complex_elementprod_map_sets_against_jax_vmap(rng, conj):
    """One map set a slice, against a vmap of the JAX kernel over the batch
    (what the JAX package's stream runs), at the elementwise tolerance."""
    k, s = _batch(rng)
    want = np.asarray(jax.vmap(lambda a, b: j_cprod(a, b, conj))(jnp.asarray(k),
                                                                 jnp.asarray(s)))
    np.testing.assert_allclose(complex_elementprod(_t(k), _t(s), conj).numpy(), want, **ELEM)


@pytest.mark.parametrize("combine", ["sum", "rss"])
def test_fused_map_sets_against_jax_vmap(rng, combine):
    """fused_epilogue and fused_recon with one map set a slice against a
    vmap of the JAX kernels (tolerances of their single-slice tests)."""
    k, s = _batch(rng)
    jk, js = jnp.asarray(k), jnp.asarray(s)
    want_e = np.asarray(jax.vmap(lambda a, b: j_epilogue(a, b, combine=combine))(jk, js))
    np.testing.assert_allclose(fused_epilogue(_t(k), _t(s), combine).numpy(), want_e, **SUM)
    want_r = np.asarray(jax.vmap(lambda a, b: j_recon(a, b, combine=combine))(jk, js))
    np.testing.assert_allclose(fused_recon(_t(k), _t(s), combine).numpy(), want_r, **DFT)


def test_one_map_set_broadcasts_over_the_batch(rng):
    """Maps bound statically (one set, (C, H, W)) against a batch: every
    slice reads them, as the single-slice call on the batch folded into
    frames, bit for bit on the plain versions."""
    k, s = _batch(rng)
    b, f, c, h, w = BATCHED
    one = _t(s[0])
    fold = _t(k.reshape(b * f, c, h, w))
    for got, want in (
            (complex_elementprod(_t(k), one, True), complex_elementprod(fold, one, True)),
            (fused_epilogue(_t(k), one, "rss"), fused_epilogue(fold, one, "rss")),
            (fused_recon(_t(k), one), fused_recon(fold, one))):
        assert torch.equal(got.reshape(want.shape), want)


def _kernel_source() -> str:
    return (_build.CSRC / "mri_kernels.cu").read_text()


def test_map_set_index_arithmetic_of_the_kernels(rng):
    """The kernels' map-set indexing, read from the .cu and walked on flat
    arrays: ``cprod_kernel`` reads ``b[(f0 / fpm) * m + j]`` for the frames
    f0..f0+fpm-1 of a set, ``fused_epilogue_kernel`` ``s + (f / fpm) * coils
    * hw + p``; frames and fpm as the wrappers pass them (``map_sets``,
    ``_check_pair``).  The gathered products and coil sums equal the plain
    versions (bit for bit for the product, in coil order for the sum)."""
    src = _kernel_source()
    assert "float2 bj = b[(f0 / fpm) * m + j];" in src
    assert "const float2* sf = s + (f / fpm) * coils * hw + p;" in src
    assert re.search(r"cmul_conj\(src\[c \* hw\], sf\[c \* hw\]\)", src)
    k, s = _batch(rng)
    b, f, c, h, w = BATCHED
    frames, m, fpm = map_sets(_t(k), _t(s))
    assert (frames, m, fpm) == (b * f, c * h * w, f)
    assert _check_pair(_t(k), _t(s), "sum") == f
    assert map_sets(_t(k), _t(s[0]))[2] == b * f == _check_pair(_t(k), _t(s[0]), "sum")
    flat_a, flat_b = k.reshape(-1), np.conj(s.reshape(-1))
    fr = np.repeat(np.arange(frames), m)
    j = np.tile(np.arange(m), frames)
    prod = _t(flat_a[fr * m + j]) * _t(flat_b[(fr // fpm) * m + j])    # torch's product
    want = complex_elementprod(_t(k), _t(s), True).reshape(-1)
    assert torch.equal(prod, want)
    hw = h * w
    x = k.reshape(frames, c, hw)
    acc = np.zeros((frames, hw), np.complex64)
    for ci in range(c):        # the kernel's coil order
        idx = (np.arange(frames)[:, None] // fpm) * c * hw + ci * hw + np.arange(hw)[None]
        acc += x[:, ci] * np.conj(s.reshape(-1)[idx])
    np.testing.assert_allclose(acc.reshape(b, f, h, w),
                               fused_epilogue(_t(k), _t(s)).numpy(), **SUM)


def test_map_set_shapes_are_checked(rng):
    k, s = _batch(rng)
    with pytest.raises(ValueError, match="bad shapes"):
        complex_elementprod(_t(k), _t(s[:1]))          # B of the maps != B of k
    with pytest.raises(ValueError, match="coil grid"):
        fused_epilogue(_t(k), _t(s[:1]))
    with pytest.raises(ValueError, match="coil grid"):
        fused_recon(_t(k[0]), _t(s))                   # 4-D k-space takes one set
