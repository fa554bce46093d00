"""Fan-in graphs on the port (``Pipeline.from_graph``, joins on named
edges) in launch mode, on the CPU: the reference's graph tests
(``tests/test_pipeline.py``, ``tests/test_joins.py``) ported to the launch
mode, the MRI fan-in graph and ``SimpleMRIRecon(join=True)`` against the
same graphs in the JAX package at SMOKE size (rtol 1e-5, the band of a
single launch), the compiled launch of a join graph through
``test_torch_compiled_launch.py``'s recorder, and the port's MRI example.
"""
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import processes as jproc
from repro.processes.coil_combine import CombineParams as JCombineParams
from repro.processes.complex_elementprod import (
    ComplexElementProdParams as JComplexElementProdParams)
from repro.processes.fft import FFTParams as JFFTParams
import repro_torch.core as tcore
import repro_torch.processes as tproc
from repro_torch.configs.mri_recon import SMOKE
from repro_torch.core import (CLapp, Data, DeviceTraits, DeviceType, GraphError, KData,
                              NoMatchingDeviceError, Pipeline, Port, PortError, Process, XData)
from repro_torch.launch import mri_recon
from repro_torch.processes import (CombineParams, ComplexElementProdParams, FFTParams,
                                   SimpleMRIRecon)
from test_torch_compiled_launch import rec  # noqa: F401  (the recorder fixture)

SHAPE = (SMOKE.frames, SMOKE.coils, SMOKE.height, SMOKE.width)
SINGLE = dict(rtol=1e-5, atol=1e-6)


class AddConst(Process):
    def apply(self, views, aux, params, out=None):
        c = params if params is not None else 1.0
        return {k: v + c for k, v in views.items()}


class Scale(Process):
    def apply(self, views, aux, params, out=None):
        return {k: v * params for k, v in views.items()}


class AddTwo(Process):
    """Primary input + a second input port 'rhs'."""

    ports = {"in": Port(names=("img",)), "out": Port(names=("img",)),
             "rhs": Port(names=("img",))}

    def apply(self, views, aux, params, out=None):
        return {"img": views["img"] + aux["rhs"]["img"]}


@pytest.fixture
def app():
    return CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))


def _img(rng, shape=(6, 5)):
    return XData({"img": rng.standard_normal(shape).astype(np.float32)})


def _host(d):
    return d.get_ndarray(0).host


# ---------------------------------------------------------------------------
# from tests/test_pipeline.py
# ---------------------------------------------------------------------------

def test_from_graph_detects_cycle(app):
    a = AddConst(app).bind(infile="x", outfile="y")
    b = Scale(app).bind(infile="y", outfile="x")
    with pytest.raises(GraphError, match=r"cycle .*edges involved: \['x', 'y'\]"):
        Pipeline.from_graph(app, [a, b])


def test_from_graph_rejects_multiple_anonymous_inputs(app):
    a = AddConst(app)
    b = Scale(app).bind(params=2.0)
    with pytest.raises(GraphError, match="anonymous input"):
        Pipeline.from_graph(app, [a.bind(outfile="y"), b])


def test_from_graph_accepts_multiple_named_inputs(app, rng):
    a = AddConst(app).bind(infile="in1", outfile="y", params=1.0)
    b = Scale(app).bind(infile="in2", outfile="z", params=3.0)
    pipe = Pipeline.from_graph(app, [a, b], output="z")
    assert pipe.input_edges == ("in1", "in2")
    d1, d2 = _img(rng), _img(rng)
    out = pipe.run({"in1": d1, "in2": d2})
    np.testing.assert_allclose(_host(out), _host(d2) * 3.0, rtol=1e-6)


def test_from_graph_fork_and_order_independence(app, rng):
    """Nodes arrive shuffled; from_graph sorts them.  The fork (Scale reads
    the graph input edge, not AddConst's output) is honoured."""
    base = rng.standard_normal((5, 5)).astype(np.float32)
    add = AddConst(app).bind(infile="src", outfile="plus1", params=1.0)
    scale = Scale(app).bind(infile="src", outfile="tripled", params=3.0)
    pipe = Pipeline.from_graph(app, [scale, add], output="tripled")
    np.testing.assert_allclose(_host(pipe.run(XData({"img": base.copy()}))), base * 3.0,
                               rtol=1e-6)
    series = Pipeline.from_graph(
        app, [Scale(app).bind(infile="mid", outfile="done", params=3.0),
              AddConst(app).bind(infile="src2", outfile="mid", params=1.0)],
        output="done")
    np.testing.assert_allclose(_host(series.run(XData({"img": base.copy()}))),
                               (base + 1.0) * 3.0, rtol=1e-6)


def test_fused_pipeline_matches_staged(app, rng):
    base = rng.standard_normal((6, 6)).astype(np.float32)

    def run(fuse):
        pipe = (Pipeline(app, fuse=fuse)
                | AddConst(app).bind(params=0.5) | Scale(app).bind(params=4.0))
        assert pipe.build(XData({"img": base})).executor.mode == ("fused" if fuse
                                                                   else "staged")
        return _host(pipe.run(XData({"img": base.copy()})))

    np.testing.assert_allclose(run(False), run(True), rtol=1e-6)
    np.testing.assert_allclose(run(True), (base + 0.5) * 4.0, rtol=1e-6)


def test_fuse_needs_the_output_from_the_last_node(app):
    a = AddConst(app).bind(infile="x", outfile="y")
    b = Scale(app).bind(infile="x", outfile="z", params=2.0)
    with pytest.raises(GraphError, match="fuse=True requires the output edge \\('y'\\)"):
        Pipeline(app, [a, b], fuse=True, output="y")


# ---------------------------------------------------------------------------
# from tests/test_joins.py
# ---------------------------------------------------------------------------

def _join_graph(app):
    a = AddConst(app).bind(infile="x", outfile="lhs", params=1.0)
    j = AddTwo(app).bind(infile="lhs", outfile="sum", rhs="r")
    return Pipeline.from_graph(app, [a, j], output="sum")


def test_join_edge_specs_validated_at_build(app, rng):
    """The joined edge's specs go through Port.validate: a rhs Data without
    the required array is refused before anything is registered."""
    pipe = _join_graph(app)
    n_data = len(app._data)
    with pytest.raises(PortError, match="missing required arrays"):
        pipe.build({"x": _img(rng), "r": XData({"nope": np.zeros((6, 5), np.float32)})})
    assert len(app._data) == n_data, "validation must not register anything"


def test_join_shape_mismatch_rejected_at_build(app, rng):
    with pytest.raises(PortError):
        _join_graph(app).build({"x": _img(rng, (6, 5)), "r": _img(rng, (3, 3))})


def test_linear_pipeline_join_must_be_produced_upstream(app):
    """In '|' composition a join edge produced LATER is mis-wired; the
    GraphError names the edge."""
    j = AddTwo(app).bind(rhs="late")
    mk = AddConst(app).bind(outfile="late", params=0.0)
    with pytest.raises(GraphError, match="'late'.*graph input"):
        Pipeline(app) | AddConst(app).bind(params=1.0) | j | mk


def test_linear_pipeline_join_of_produced_edge(app, rng):
    """A '|' pipeline can join an upstream edge: a diamond over 'src'."""
    base = rng.standard_normal((5, 5)).astype(np.float32)
    pipe = (Pipeline(app)
            | AddConst(app).bind(infile="src", outfile="plus", params=2.0)
            | AddTwo(app).bind(infile="plus", rhs="src"))
    np.testing.assert_allclose(_host(pipe.run(XData({"img": base.copy()}))),
                               (base + 2.0) + base, rtol=1e-6)


def test_run_mapping_missing_edge_names_edges(app, rng):
    pipe = _join_graph(app)
    with pytest.raises(GraphError, match="'r'"):
        pipe.run({"x": _img(rng)})
    with pytest.raises(GraphError, match="unknown edges.*typo"):
        pipe.run({"x": _img(rng), "r": _img(rng), "typo": _img(rng)})
    with pytest.raises(GraphError, match="multiple|input edges"):
        pipe.run(_img(rng))


def test_self_join_same_edge_into_two_ports(app, rng):
    """One edge bound to both input ports of a node (x + x)."""
    pipe = Pipeline.from_graph(app, [AddTwo(app).bind(infile="x", outfile="sum", rhs="x")],
                               output="sum")
    assert pipe.input_edges == ("x",)
    for d in (_img(rng), _img(rng)):
        np.testing.assert_allclose(_host(pipe.run({"x": d})), 2.0 * _host(d), rtol=1e-6)


def test_from_graph_output_reorder_keeps_anonymous_input_first(app, rng):
    """Moving the output producer last must never move the anonymous-input
    node off position 0: linear planning would rewire its input."""
    a = AddConst(app).bind(outfile="y", params=1.0)       # anonymous input
    b = Scale(app).bind(infile="in2", outfile="z", params=3.0)
    pipe = Pipeline.from_graph(app, [a, b], output="y")
    assert set(pipe.input_edges) == {"_in", "in2"}
    ones = XData({"img": np.ones((3, 3), np.float32)})
    out = pipe.run({"_in": ones, "in2": _img(rng, (3, 3))})
    np.testing.assert_allclose(_host(out), np.full((3, 3), 2.0), rtol=1e-6)


def test_positional_tuple_inputs_before_build(app, rng):
    """A tuple in Pipeline.input_edges order works as the first call on an
    unbuilt fan-in pipeline."""
    pipe = _join_graph(app)
    assert pipe.input_edges == ("x", "r")
    lhs, rhs = _img(rng), _img(rng)
    out = pipe.run((lhs, rhs))
    np.testing.assert_allclose(_host(out), (_host(lhs) + 1.0) + _host(rhs), rtol=1e-6)
    with pytest.raises(GraphError, match="supply 1 Data"):
        pipe.run((lhs,))


# ---------------------------------------------------------------------------
# the MRI fan-in graph against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mri():
    rng = np.random.default_rng(19)
    f, c, h, w = SHAPE
    k = (rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)
    s = (rng.standard_normal((c, h, w)) + 1j * rng.standard_normal((c, h, w))
         ).astype(np.complex64)
    return k, s


def _mri_fanin(core_mod, procs, params, app, fuse=False):
    """The same fan-in graph in either package, nodes given out of order."""
    fft_p, prod_p, comb_p = params
    fft = procs.FFT(app).bind(infile="kspace", outfile="xspace",
                              params=fft_p("backward", var="kdata"))
    prod = procs.ComplexElementProd(app).bind(infile="xspace", outfile="weighted",
                                              smaps="smaps", params=prod_p(conjugate=True))
    comb = procs.XImageSum(app).bind(infile="weighted", outfile="image", params=comb_p())
    return core_mod.Pipeline.from_graph(app, [comb, fft, prod], output="image", fuse=fuse)


TORCH = (tcore, tproc, (FFTParams, ComplexElementProdParams, CombineParams))
JAX = (jcore, jproc, (JFFTParams, JComplexElementProdParams, JCombineParams))


def _items(core_mod, k, s):
    return {"kspace": core_mod.Data({"kdata": k.copy()}),
            "smaps": core_mod.Data({"sensitivity_maps": s.copy()})}


@pytest.mark.parametrize("fuse", [False, True])
def test_mri_fanin_graph_matches_jax(app, mri, fuse):
    k, s = mri
    jpipe = _mri_fanin(*JAX[:2], JAX[2], jcore.CLapp().init(), fuse)
    want = np.asarray(_host(jpipe.run(_items(jcore, k, s))))
    pipe = _mri_fanin(*TORCH[:2], TORCH[2], app, fuse)
    assert pipe.input_edges == jpipe.input_edges == ("kspace", "smaps")
    assert [n.name for n in pipe.nodes] == [n.name for n in jpipe.nodes]
    got = _host(pipe.run(_items(tcore, k, s)))
    np.testing.assert_allclose(got, want, **SINGLE)
    assert pipe.residency_plan == jpipe.residency_plan == {
        "kspace": "host", "smaps": "host", "xspace": "device", "weighted": "device",
        "image": "host"}
    # a second item through the same built graph, both edges new
    k2, s2 = k[::-1].copy(), (s * (1 - 2j)).astype(np.complex64)
    want2 = np.asarray(_host(jpipe.run(_items(jcore, k2, s2))))
    got2 = _host(pipe.run(_items(tcore, k2, s2)))
    np.testing.assert_allclose(got2, want2, **SINGLE)


@pytest.mark.parametrize("mode", ["staged", "fused"])
def test_simple_mri_recon_join_through_from_graph_matches_jax(app, mri, mode):
    k, s = mri
    japp = jcore.CLapp().init()
    jpipe = jcore.Pipeline.from_graph(japp, [jproc.SimpleMRIRecon(
        japp, mode=mode, in_place=False, join=True).bind(infile="kspace", smaps="smaps")])
    want = np.asarray(_host(jpipe.run(_items(jcore, k, s))))
    recon = SimpleMRIRecon(app, mode=mode, in_place=False, join=True)
    pipe = Pipeline.from_graph(app, [recon.bind(infile="kspace", smaps="smaps")])
    assert pipe.input_edges == ("kspace", "smaps")
    got = _host(pipe.run(_items(tcore, k, s)))
    np.testing.assert_allclose(got, want, **SINGLE)
    assert pipe.residency_plan == jpipe.residency_plan
    # the same port bound statically gives the same image, bit for bit
    static = Pipeline(app) | SimpleMRIRecon(app, mode=mode, in_place=False, join=True).bind(
        infile="kspace", smaps=Data({"sensitivity_maps": s}))
    np.testing.assert_array_equal(_host(static.run(Data({"kdata": k}))), got)


def test_a_join_graph_replays_new_inputs_on_both_edges(rec, app, mri):
    """Compiled as on the card (the recorder of test_torch_compiled_launch):
    the first run eager, the second captures, later runs replay; every run
    brings a new k-space and new maps, each replay reads both, and no input
    blob moves (the recorder fails a replay whose blob moved)."""
    pipe = _mri_fanin(*TORCH[:2], TORCH[2], app)
    k, s = mri
    blobs = None
    for r in range(5):
        kr = (k * (r + 1)).astype(np.complex64)
        sr = (s * np.exp(1j * r)).astype(np.complex64)
        out = pipe.run({"kspace": Data({"kdata": kr}), "smaps": Data({"sensitivity_maps": sr})})
        want = (np.conj(sr)[None] * torch.fft.ifft2(torch.from_numpy(kr), norm="ortho").numpy()
                ).sum(axis=1)
        np.testing.assert_allclose(_host(out), want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"run {r + 1}")
        built = pipe.build()
        now = {e: app.getData(h).device_blob.data_ptr() for e, h in built.input_handles.items()}
        assert blobs is None or now == blobs, f"an input blob moved on run {r + 1}"
        blobs = now
    chain = pipe.build().executor
    assert rec.events == ["capture"] + ["replay"] * 4
    assert (chain.captures, chain.replays) == (1, 4)


# ---------------------------------------------------------------------------
# the port's MRI example, file in, file out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--pipeline", "--join"], ["--fused", "--join"],
                                  ["--kernel", "--pipeline", "--join"]])
def test_mri_recon_example_at_smoke_size(app, tmp_path, argv):
    out = str(tmp_path / "frames")
    res = mri_recon.main(argv + ["--out", out], app=app, cfg=SMOKE)
    assert res["device"] == "cpu" and res["out_path"] == out + ".npz"
    kdata, smaps, _ = mri_recon.synthetic_kdata(*SHAPE)
    want = mri_recon.oracle_recon(kdata, smaps)
    np.testing.assert_allclose(np.load(out + ".npz")["xdata"], want, rtol=1e-4, atol=1e-4)
    for key in ("load_ms", "upload_ms", "init_ms", "launch_ms", "d2h_ms", "save_ms"):
        assert res[key] >= 0, key
    assert res["join"]["exact"] == (argv[0] == "--pipeline")
    assert res["join"]["input_edges"] == ["kspace", "smaps"]


def test_mri_recon_example_reads_a_given_kspace_file(app, tmp_path):
    k, s, _ = mri_recon.synthetic_kdata(*SHAPE, seed=3)
    path = str(tmp_path / "scan.npz")
    mri_recon.save_any(path, {KData.SMAPS: s, KData.KDATA: k})      # maps first
    res = mri_recon.main(["--kspace", path, "--out", str(tmp_path / "o.npz")], app=app)
    np.testing.assert_allclose(np.load(tmp_path / "o.npz")["xdata"],
                               mri_recon.oracle_recon(k, s), rtol=1e-4, atol=1e-4)
    assert res["mode"] == "staged" and "join" not in res


def test_mri_recon_example_runs_on_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoMatchingDeviceError):
        mri_recon.main(["--out", str(tmp_path / "o.npz")])
