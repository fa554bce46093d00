"""The port's listing-1 path (the ``negate`` kernel, the ``Negate`` process
and the quickstart walkthrough) against the JAX package's, on the same
numpy inputs.  ``1 - x`` is one rounding of an exact difference, so every
comparison here is bit for bit.  The CUDA kernel's index arithmetic is
walked here thread by thread; the kernel itself is held against the plain
version on the card by ``chip_smoke.py``."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CLapp as JApp, Pipeline as JPipeline, XData as JXData
from repro.kernels.negate import negate as j_negate
from repro.processes.negate import Negate as JNegate, NegateParams as JNegateParams
from repro_torch.core import (CLapp, DeviceTraits, DeviceType, NoMatchingDeviceError, Pipeline,
                              PortError, ProfileParameters, XData)
from repro_torch.core.registry import launch_counts
from repro_torch.kernels import _build
from repro_torch.kernels.negate import negate
from repro_torch.launch import quickstart
from repro_torch.processes import Negate


def _cpu_app():
    return CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))


@pytest.mark.parametrize("shape", [(7,), (128,), (3, 5, 17), (256, 256), (1,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_negate_matches_pallas_bit_for_bit(rng, shape, dtype):
    x = (rng.random(shape) * 4 - 2).astype(np.float32)
    want = np.asarray(j_negate(jnp.asarray(x, dtype)), np.float32)
    got = negate(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_negate_writes_out_in_place(rng):
    x = torch.from_numpy(rng.random((4, 9)).astype(np.float32))
    want = 1.0 - x
    assert negate(x, out=x) is x
    assert torch.equal(x, want)
    before = launch_counts()
    m = torch.empty(3, device="meta")           # a dry run's trace: the layout, no launch
    out = negate(m)
    assert (out.device.type, tuple(out.shape)) == ("meta", (3,))
    assert negate(m, out=m) is m
    assert launch_counts() == before


def _kernel_constants():
    """Threads a block, SMs, the grid cap and U (the most 16-byte vectors in
    flight per thread), read from the kernel's source."""
    src = (_build.CSRC / "negate_kernels.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    per_sm = int(re.search(r"constexpr int kMaxBlocks = kSMs \* (\d+);", src).group(1))
    return (int(const["kThreads"]), int(const["kSMs"]), int(const["kSMs"]) * per_sm,
            int(const["kNegUnroll"]))


def _negate_batch(n, itemsize, aligned):
    """The 16-byte vectors per batch that ``launch_negate`` picks: U when
    the batches give every SM a block, else 1; 0 (scalar) when misaligned."""
    threads, sms, _, unroll = _kernel_constants()
    if not aligned:
        return 0
    return unroll if n // (16 // itemsize * unroll) >= sms * threads else 1


def _negate_kernel_writes(n, itemsize, u):
    """Every element index that ``negate_kernel`` writes for n elements in
    batches of u vectors (0: the scalar loop), with repeats, from the index
    arithmetic of its source: the grid sized from the batches (or the
    elements); each thread's batch i at (i & ~31) * u + (i - (i & ~31)) +
    q * L for q < u, L the live batches of its warp; then the scalar tail
    from the last whole batch, both in grid-stride loops."""
    threads, _, max_blocks, _ = _kernel_constants()
    vec = 16 // itemsize
    nb = n // (vec * u) if u else 0
    blocks = min(max(-(-(nb if u else n) // threads), 1), max_blocks)
    stride = blocks * threads
    tid = np.arange(stride, dtype=np.int64)
    writes = []
    for start in range(0, nb, stride):
        i = tid[tid + start < nb] + start
        first = i & ~31
        lanes = np.minimum(nb - first, 32)
        at = first * u + (i - first)
        for q in range(u):
            writes.append(((at + q * lanes)[:, None] * vec + np.arange(vec)).ravel())
    for start in range(nb * vec * u, n, stride):
        writes.append(tid[tid + start < n] + start)
    return np.concatenate(writes)


def test_negate_kernel_batches_by_size():
    """One vector per thread for the quickstart's 256 x 256 image (128
    blocks, not 32), four for a 4096 x 4096 one; misaligned: scalar."""
    assert _negate_batch(256 * 256, 4, True) == 1
    assert _negate_batch(4096 * 4096, 4, True) == _kernel_constants()[3] == 4
    assert _negate_batch(4096 * 4096, 2, False) == 0


@pytest.mark.parametrize("n", ["1", "VU-1", "VU+1", "1000003"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", ["U", "1", "misaligned"])
def test_negate_kernel_index_walk_covers_each_element_once(rng, n, dtype, batch):
    """The kernel's batches of U (or 1) vectors, then its scalar tail, or
    its scalar loop for a misaligned view, write each element exactly once;
    applying ``1 - x`` at those indices gives the plain version bit for
    bit."""
    itemsize = 4 if dtype == "float32" else 2
    unroll = _kernel_constants()[3]
    vu = 16 // itemsize * unroll
    n = {"1": 1, "VU-1": vu - 1, "VU+1": vu + 1, "1000003": 1000003}[n]
    idx = _negate_kernel_writes(n, itemsize, {"U": unroll, "1": 1, "misaligned": 0}[batch])
    assert np.array_equal(np.bincount(idx, minlength=n), np.ones(n, np.int64))
    x = torch.from_numpy((rng.random(n) * 4 - 2).astype(np.float32)).to(getattr(torch, dtype))
    got = torch.empty_like(x)
    at = torch.from_numpy(idx)
    got[at] = (1.0 - x[at].float()).to(x.dtype)
    assert torch.equal(got, negate(x))


def test_negate_pipeline_matches_reference(rng):
    """``Pipeline(app) | Negate(app)`` over a two-array Data set on a CPU app
    against the JAX package's pipeline (its Pallas kernel in interpret
    mode): every array, bit for bit; plain runs count no kernel launch."""
    arrays = {"img": rng.random((32, 48)).astype(np.float32),
              "vol": rng.standard_normal((3, 8, 8)).astype(np.float32)}
    japp = JApp().init()
    japp.loadKernels("negate")
    jpipe = JPipeline(japp) | JNegate(japp).bind(params=JNegateParams(use_pallas=True))
    want = jpipe.run(JXData(dict(arrays)))
    app = _cpu_app()
    assert app.loadKernels("negate") == ["negate_kernel"]
    pipe = Pipeline(app) | Negate(app).bind()
    before = launch_counts()
    prof = ProfileParameters(enable=True)
    for _ in range(3):
        got = pipe.run(XData(dict(arrays)), profile=prof)
    assert launch_counts() == before
    assert len(prof.samples) == 3
    for i, name in enumerate(arrays):
        np.testing.assert_array_equal(got.get_ndarray(i).host, want.get_ndarray(i).host)
        np.testing.assert_array_equal(got.get_ndarray(i).host, 1.0 - arrays[name])


def test_negate_refuses_integer_data():
    """The ``in`` port takes float arrays only: ``1 - x`` of an integer image
    is refused when the graph is built, before anything runs."""
    app = _cpu_app()
    pipe = Pipeline(app) | Negate(app).bind()
    with pytest.raises(PortError, match="dtype"):
        pipe.run(XData({"img": np.zeros((4, 4), np.int32)}))


def test_quickstart_runs_on_a_cpu_app_when_handed_one(tmp_path):
    res = quickstart.run(_cpu_app(), runs=3, out_path=str(tmp_path / "output.png"))
    assert res["device"] == "cpu" and res["runs"] == 3 and res["mean_launch_s"] > 0
    assert res["out_path"] == str(tmp_path / "output.png")
    img = quickstart.synthetic_image()
    assert img.shape == (256, 256) and img.dtype == np.float32
    np.testing.assert_array_equal(res["image"], 1.0 - img)


def test_quickstart_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoMatchingDeviceError):
        quickstart.run()
