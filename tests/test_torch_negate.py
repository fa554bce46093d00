"""The port's listing-1 path (the ``negate`` kernel, the ``Negate`` process
and the quickstart walkthrough) against the JAX package's, on the same
numpy inputs.  ``1 - x`` is one rounding of an exact difference, so every
comparison here is bit for bit.  The CUDA kernel is held against the plain
version on the card by ``chip_smoke.py``."""
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
    with pytest.raises(ValueError, match="CUDA"):
        negate(torch.empty(3, device="meta"))


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


def test_quickstart_runs_on_a_cpu_app_when_handed_one():
    res = quickstart.run(_cpu_app(), runs=3)
    assert res["device"] == "cpu" and res["runs"] == 3 and res["mean_launch_s"] > 0
    img = quickstart.synthetic_image()
    assert img.shape == (256, 256) and img.dtype == np.float32
    np.testing.assert_array_equal(res["image"], 1.0 - img)


def test_quickstart_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoMatchingDeviceError):
        quickstart.run()
