"""The LM kernels' wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels, run as ``tests/test_kernels.py`` runs them
(interpret mode off the TPU), on that file's grids and tolerances:
rmsnorm 1e-5 in f32 and 3e-2 in bf16 (one bf16 rounding of the output),
attention 2e-5 in f32 and 5e-2 in bf16.  Inputs are made in f32 with numpy
and rounded to bf16 by each framework (both round to nearest even, so both
sides see the same bits).  The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.rmsnorm import rmsnorm as j_rmsnorm
from repro_torch.core.registry import KernelRegistry, launch_counts
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x32: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x32, jd), torch.from_numpy(x32).to(td)


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 96), (17, 128), (1, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(rng, shape, dtype):
    x32 = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    jx, tx = _pair(x32, dtype)
    want = np.asarray(j_rmsnorm(jx, jnp.asarray(w)), np.float32)
    got = rmsnorm(tx, torch.from_numpy(w))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,d,causal,window",
    [
        (2, 4, 2, 32, 32, 16, True, None),    # GQA causal
        (1, 4, 4, 24, 24, 8, False, None),    # MHA bidirectional
        (2, 8, 2, 16, 48, 16, True, None),    # kv longer than q
        (1, 2, 2, 1, 40, 8, True, None),      # single-token decode
        (1, 4, 2, 32, 32, 16, True, 8),       # sliding window
        (1, 4, 2, 33, 47, 16, True, 13),      # ragged + window
    ])
def test_flash_attention(rng, b, hq, hkv, sq, skv, d, causal, window):
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              window=window, block_q=16, block_k=16))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16(rng):
    q, k, v = (rng.standard_normal((1, 2, 16, 32)).astype(np.float32) for _ in range(3))
    jq, tq = _pair(q, "bfloat16")
    jk, tk = _pair(k, "bfloat16")
    jv, tv = _pair(v, "bfloat16")
    want = np.asarray(j_flash(jq, jk, jv, block_q=8, block_k=8), np.float32)
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)


def test_plain_attention_chunked_equals_dense(rng, monkeypatch):
    """The q-chunked long-sequence path of the plain version equals the
    dense one, as the JAX package's ``ref.attention`` does."""
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, 16)).astype(np.float32))
               for _ in range(3))
    dense = ref.attention(q, k, v, window=24)
    monkeypatch.setattr(ref, "ATTN_CHUNK_THRESHOLD", 64)
    monkeypatch.setattr(ref, "ATTN_CHUNK", 32)
    np.testing.assert_allclose(ref.attention(q, k, v, window=24).numpy(), dense.numpy(),
                               rtol=1e-6, atol=1e-6)
    want = np.asarray(jref.attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                     jnp.asarray(v.numpy()), window=24))
    np.testing.assert_allclose(dense.numpy(), want, rtol=2e-5, atol=2e-5)


def test_registry_names_and_cpu_runs_count_no_launch(rng):
    reg = KernelRegistry()
    assert sorted(reg.load(["rmsnorm", "flash_attention"])) == ["flash_attention", "rmsnorm"]
    assert reg.get("rmsnorm") is ops.rmsnorm
    assert reg.ref("flash_attention") is ref.attention
    before = launch_counts()
    x = torch.from_numpy(rng.standard_normal((2, 2, 5, 16)).astype(np.float32))
    reg.get("rmsnorm")(x, torch.ones(16))
    reg.get("flash_attention")(x, x, x)
    assert launch_counts() == before     # plain versions are no launches


def test_wrappers_raise_off_cpu_and_cuda():
    """Plain versions run only for CPU tensors; any other device launches the
    kernel or raises (meta has no kernel)."""
    m = torch.empty((2, 4, 8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(m, torch.empty(64, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(m, m, m)


def test_wrappers_check_shapes_before_choosing_a_device():
    x = torch.zeros(2, 3, 8, 16)
    with pytest.raises(ValueError, match="does not match"):
        rmsnorm(x, torch.ones(8))
    with pytest.raises(ValueError, match="do not pair"):
        flash_attention(x, torch.zeros(2, 2, 8, 16), torch.zeros(2, 2, 8, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention(x, x, x, window=0)


def test_kernel_library_exports_the_lm_entry_points():
    """Both entry points are bound with explicit C types (a pointer passed
    without its type would be cut to 32 bits), and the library is named for
    the whole port, not one path."""
    assert _build.NVCC_FLAGS[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")
    assert len(_build._SIGNATURES["rt_rmsnorm"]) == 9
    assert len(_build._SIGNATURES["rt_flash_attention"]) == 15
    assert {p.name for p in _build.sources()} >= {"lm_kernels.cu", "mri_kernels.cu"}
