"""The port's graph layer (``Process.bind``, ``Node``, ``Pipeline`` in launch
mode): validation at bind/build time, spec inference, edge allocation,
residency, and a chain built with ``|`` against the numpy oracle of the
MRI reconstruction (rtol 1e-4 / atol 1e-4, the band of the fused modes)."""
import numpy as np
import pytest
import torch

from repro_torch.core import (CLapp, Coherence, Data, DeviceTraits, DeviceType, GraphError,
                              KData, Pipeline, PortError, ProfileParameters, XData)
from repro_torch.processes import (FFT, ComplexElementProd, ComplexElementProdParams,
                                   FFTParams, XImageSum)


@pytest.fixture
def app():
    return CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))


@pytest.fixture(scope="module")
def mri():
    rng = np.random.default_rng(3)
    k = (rng.standard_normal((2, 3, 8, 6)) + 1j * rng.standard_normal((2, 3, 8, 6))
         ).astype(np.complex64)
    s = (rng.standard_normal((3, 8, 6)) + 1j * rng.standard_normal((3, 8, 6))
         ).astype(np.complex64)
    want = (np.conj(s.astype(np.complex128))[None]
            * np.fft.ifft2(k.astype(np.complex128), norm="ortho")).sum(axis=1)
    return k, s, want


def _chain(app, smaps=None):
    prod = ComplexElementProd(app).bind(params=ComplexElementProdParams(conjugate=True),
                                        **({} if smaps is None else {"smaps": smaps}))
    return (Pipeline(app)
            | FFT(app).bind(infile="kspace", outfile="xspace",
                            params=FFTParams("backward", var="kdata"))
            | prod
            | XImageSum(app).bind(outfile="image"))


@pytest.mark.parametrize("joined", [False, True])
def test_linear_chain_matches_the_oracle(app, mri, joined):
    k, s, want = mri
    if joined:     # the maps as their own Data on the secondary "smaps" port
        pipe = _chain(app, smaps=Data({"sensitivity_maps": s}))
        inputs = Data({"kdata": k})
    else:
        pipe = _chain(app)
        inputs = KData({"kdata": k, "sensitivity_maps": s})
    out = pipe.run(inputs)
    np.testing.assert_allclose(out.get_ndarray(0).host, want, rtol=1e-4, atol=1e-4)
    # intermediate edges were allocated from inferred specs and stay on the device
    assert pipe.residency_plan == {"kspace": "host", "xspace": "device", "_e1": "device",
                                   "image": "host"}
    # a second input reuses the built graph and its buffers
    out2 = pipe.run(KData({"kdata": 2 * k, "sensitivity_maps": s}) if not joined
                    else Data({"kdata": 2 * k}))
    np.testing.assert_allclose(out2.get_ndarray(0).host, 2 * want, rtol=1e-4, atol=1e-4)


def test_run_records_the_input_upload_as_transfer(app, mri):
    k, s, _ = mri
    prof = ProfileParameters(enable=True)
    _chain(app).run(KData({"kdata": k, "sensitivity_maps": s}), profile=prof, sync=False)
    assert len(prof.phases["transfer"]) == 1 and prof.phase_total("transfer") > 0
    assert len(prof.samples) == 1


def test_bind_rejects_unknown_ports_and_bad_data(app):
    with pytest.raises(PortError, match="no input port"):
        XImageSum(app).bind(nope=Data({"x": np.zeros(2, np.float32)}))
    with pytest.raises(PortError, match="missing required arrays"):
        ComplexElementProd(app).bind(infile=Data({"wrong": np.zeros((1, 1, 2, 2),
                                                                    np.complex64)}))
    # a secondary port bound to an edge name is a join; to anything but an
    # edge, a Data or a handle, it is refused
    assert ComplexElementProd(app).bind(smaps="maps_edge").input_bind == {"smaps": "maps_edge"}
    with pytest.raises(PortError, match="must be an edge name"):
        ComplexElementProd(app).bind(smaps=1.5)


def test_mis_wired_graphs_fail_when_composed(app):
    fft = FFT(app).bind(outfile="x")
    with pytest.raises(GraphError, match="no upstream node produces"):
        Pipeline(app) | fft | XImageSum(app).bind(infile="typo_edge")
    with pytest.raises(GraphError, match="produced twice"):
        Pipeline(app) | FFT(app).bind(outfile="e") | FFT(app).bind(infile="e", outfile="e")
    with pytest.raises(GraphError, match="only the first node"):
        Pipeline(app) | fft | XImageSum(app).bind(
            infile=Data({"kdata": np.zeros((1, 1, 2, 2), np.complex64)}))
    with pytest.raises(GraphError, match="only the last node"):
        (Pipeline(app) | FFT(app).bind(outfile=XData({"x": np.zeros(2)}))
         | XImageSum(app))


def test_build_checks_specs_between_nodes(app, mri):
    k, s, _ = mri
    # XImageSum needs a 4-d "kdata"; a 3-d one is refused before anything runs
    with pytest.raises(PortError, match="ndim"):
        (Pipeline(app) | XImageSum(app)).build(KData({"kdata": k[0],
                                                     "sensitivity_maps": s}))
    # a bound output Data of the wrong shape is refused too
    bad = XData({"xdata": np.zeros((2, 8, 5), np.complex64)})
    with pytest.raises(PortError, match="do not match"):
        (Pipeline(app) | XImageSum(app).bind(outfile=bad)).build(
            KData({"kdata": k, "sensitivity_maps": s}))
    with pytest.raises(GraphError, match="no Data for the input edge"):
        (Pipeline(app) | XImageSum(app)).build()


def test_only_launch_mode(app, mri):
    """One Data is the launch mode's input only: the stream mode takes a
    sequence of items (one KData is refused), an unknown mode is refused
    naming the three, and the multi-device stream runs: on an eight-lane
    CPU mesh, ``sharded=True`` equals the launch (rtol 1e-6: the FFT of a
    batch), each of the 8 slices on a lane of its own."""
    from repro_torch.launch.mesh import make_data_mesh

    k, s, _ = mri
    kd = KData({"kdata": k, "sensitivity_maps": s})
    with pytest.raises(TypeError, match="sequence of items"):
        _chain(app).run(kd, mode="stream")
    with pytest.raises(ValueError, match="'launch' \\| 'stream' \\| 'serve'"):
        _chain(app).run(kd, mode="batched")
    want = _chain(app).run(kd).get_ndarray(0).host.copy()
    app.set_mesh(make_data_mesh([torch.device("cpu")] * 8))
    pipe = _chain(app)
    outs = pipe.run([kd] * 8, mode="stream", sharded=True, batch=8)
    assert pipe.build().executor.split_vectors == [(1,) * 8]
    for o in outs:
        np.testing.assert_allclose(o.get_ndarray(0).host, want, rtol=1e-6, atol=1e-6)


def test_persistent_data_stays_on_the_device(app, mri):
    """A persistent Data on the output edge is planned device-resident and
    every write stamps it DEVICE_RESIDENT; run(sync=False) never copies it
    to the host."""
    k, s, _ = mri
    out = Data.from_specs({"xdata": XData({"xdata": np.zeros((2, 8, 6),
                                                             np.complex64)}).specs()["xdata"]})
    out.persistent = True
    h = app.addData(out, to_device=False)
    pipe = Pipeline(app) | ComplexElementProd(app).bind(
        params=ComplexElementProdParams(conjugate=True)) | XImageSum(app).bind(outfile=h)
    pipe.run(KData({"kdata": k, "sensitivity_maps": s}), sync=False)
    assert pipe.residency_plan["_out"] == "device"
    assert out.coherence is Coherence.DEVICE_RESIDENT
    assert out.get_ndarray(0).host is None
    assert app.h2d_bytes.get(h, 0) == 0
