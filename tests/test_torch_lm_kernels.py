"""The LM kernels' wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels, run as ``tests/test_kernels.py`` runs them
(interpret mode off the TPU), on that file's grids and tolerances:
rmsnorm 1e-5 in f32 and 3e-2 in bf16 (one bf16 rounding of the output),
attention 2e-5 in f32 and 5e-2 in bf16.  Inputs are made in f32 with numpy
and rounded to bf16 by each framework (both round to nearest even, so both
sides see the same bits).  The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``; the bf16 tensor-core
flash kernel's own arithmetic (64-key tiles, exp2, P rounded to bf16) is
emulated here in plain torch and held against the JAX kernel.
"""
import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.rmsnorm import rmsnorm as j_rmsnorm
from repro_torch.core.registry import KernelRegistry, launch_counts
from repro_torch.kernels import _build, common, ops, ref
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
    assert sorted(reg.load(["rmsnorm", "flash_attention"])) == [
        "flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd"]
    assert reg.get("rmsnorm") is ops.rmsnorm
    assert reg.ref("flash_attention") is ref.attention
    before = launch_counts()
    x = torch.from_numpy(rng.standard_normal((2, 2, 5, 16)).astype(np.float32))
    reg.get("rmsnorm")(x, torch.ones(16))
    reg.get("flash_attention")(x, x, x)
    assert launch_counts() == before     # plain versions are no launches


def test_wrappers_raise_off_cpu_and_cuda(monkeypatch):
    """Plain versions run only for CPU tensors: on ``meta`` tensors (a dry
    run's trace) a wrapper gives outputs of the plain layout without running
    it, and counts no launch."""
    def plain(*_a, **_k):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(ref, "rmsnorm", plain)
    monkeypatch.setattr(ref, "attention", plain)
    m = torch.empty((2, 4, 8, 64), device="meta")
    before = launch_counts()
    for out in (rmsnorm(m, torch.empty(64, device="meta")), flash_attention(m, m, m)):
        assert (out.device.type, tuple(out.shape), out.dtype) == ("meta", (2, 4, 8, 64),
                                                                  torch.float32)
    assert launch_counts() == before


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
    assert len(_build._SIGNATURES["rt_flash_attention"]) == 16    # + the log-sum-exp
    assert len(_build._SIGNATURES["rt_rmsnorm_bwd"]) == 13
    assert len(_build._SIGNATURES["rt_flash_attention_bwd"]) == 21   # + the delta scratch
    assert {p.name for p in _build.sources()} >= {"lm_kernels.cu", "mri_kernels.cu"}


def _mma_flash_emulation(q, k, v, causal, window, rows=64, keys=64):
    """The arithmetic of the bf16 ``flash_mma_kernel`` in plain torch, on
    bf16 q, k, v: query tiles of ``rows``, key tiles of ``keys`` from the
    first one a query of the tile can see to the last; S = q k^T exactly in
    f32 (bf16 products are exact) scaled by scale * log2 e in f32; the
    online softmax in f32 with exp2 (-inf masks, a row with no key yet
    takes 0 as its base); P rounded to bf16 for P V, the row sum over the
    unrounded P; rows that see no key -> 0; output rounded to bf16.  The
    kernel skips the mask on tiles every query sees whole, which changes no
    value."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group, offset = hq // hkv, skv - sq
    scale_log2 = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        math.log2(math.e), dtype=torch.float32)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    out = torch.zeros(b, hq, sq, d)
    neg_inf = torch.tensor(-math.inf)
    for q0 in range(0, sq, rows):
        q1 = min(q0 + rows, sq)
        pos = torch.arange(q0, q1) + offset
        k_end = min(skv, q1 - 1 + offset + 1) if causal else skv
        k_begin = max(0, q0 + offset - window + 1) if window else 0
        qt = q[:, :, q0:q1].float()
        m = torch.full((b, hq, q1 - q0), -math.inf)
        l = torch.zeros(b, hq, q1 - q0)
        acc = torch.zeros(b, hq, q1 - q0, d)
        for k0 in range(k_begin // keys * keys, k_end, keys):
            kt, vt = kf[:, :, k0:k0 + keys], vf[:, :, k0:k0 + keys]
            s = (qt @ kt.transpose(-1, -2)) * scale_log2
            kpos = torch.arange(k0, k0 + kt.shape[2])
            ok = torch.ones(q1 - q0, kt.shape[2], dtype=torch.bool)
            if causal:
                ok &= kpos[None] <= pos[:, None]
            if window:
                ok &= kpos[None] > pos[:, None] - window
            s = torch.where(ok, s, neg_inf)
            mx = torch.maximum(m, s.amax(dim=-1))
            base = torch.where(mx == -math.inf, 0.0, mx)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s - base[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vt
            m = mx
        out[:, :, q0:q1] = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,d,causal,window",
    [
        (1, 4, 2, 130, 130, 64, True, None),   # GQA causal, three query tiles, ragged
        (2, 4, 1, 70, 100, 80, True, 33),      # window, kv longer than q, ragged ends
    ])
def test_flash_mma_arithmetic_fits_the_bf16_tolerance(rng, b, hq, hkv, sq, skv, d, causal,
                                                      window):
    """P rounded to bf16 before P V (the tensor-core kernel's one new
    rounding) stays inside the (rtol, atol) = (2e-2, 2e-2) that
    ``chip_smoke.py`` holds the card's bf16 kernel to."""
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "bfloat16") for a in (q, k, v))
    want = np.asarray(j_flash(jq, jk, jv, causal=causal, window=window, block_q=64,
                              block_k=64), np.float32)
    got = _mma_flash_emulation(tq, tk, tv, causal, window)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_launch_helper_takes_the_tensors_device_and_current_stream(monkeypatch):
    """``common.launch`` passes the raw current-stream handle of the tensor's
    device, and switches the current device only when it differs."""
    fake = SimpleNamespace(get_device=lambda: 1, device=torch.device("cuda", 1))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i,
                        raising=False)
    switches = []

    class Guard:
        def __init__(self, idx):
            self.idx = idx

        def __enter__(self):
            switches.append(self.idx)

        def __exit__(self, *exc):
            switches.append("back")

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 1, raising=False)
    assert common.launch_stream(fake) == 1001
    assert common.launch(lambda *a: a, fake, 7, 8) == (7, 8, 1001)
    assert switches == []
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    assert common.launch(lambda *a: a, fake, 7) == (7, 1001)
    assert switches == [1, "back"]


def test_launch_helper_refuses_a_cpu_tensor():
    for t in (torch.zeros(2), torch.empty(2, device="meta")):
        with pytest.raises(ValueError, match="CUDA"):
            common.launch_stream(t)
        with pytest.raises(ValueError, match="CUDA"):
            common.launch(lambda *a: 0, t)
