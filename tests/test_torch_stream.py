"""The port's streaming executor (``repro_torch.core.stream``) on the CPU:
``Process.stream``, ``SimpleMRIRecon.stream`` and ``Pipeline.run(mode=
"stream")`` against the port's own sequential ``launch()`` and against
the JAX package's streaming executor at SMOKE size; the ragged-tail
policy; joins and item forms; the upload ring's bookkeeping, through a
recorder in the executor's stream seam (``stream._streams_for``) and the
compiled launch's recorder of ``test_torch_compiled_launch.py``.

Tolerances: against the port's sequential ``launch()``, bit for bit where
no FFT runs, rtol/atol 1e-6 where a batch goes through one FFT call (the
JAX package's own caveat for its batched FFT); against the JAX package,
rtol/atol 1e-4 (``docs/kernels.md`` §3); against the single-slice JAX
graph launched item by item, 1e-5 as ``test_torch_joins.py``.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import processes as jproc
from repro.processes.coil_combine import CombineParams as JCombineParams
from repro.processes.complex_elementprod import (
    ComplexElementProdParams as JComplexElementProdParams)
from repro.processes.fft import FFTParams as JFFTParams
from repro.processes.simple_mri_recon import FusedReconParams as JFusedReconParams
import repro_torch.core as tcore
import repro_torch.processes as tproc
from repro_torch.configs.mri_recon import SMOKE
from repro_torch.core import (BatchedProcess, CLapp, Coherence, Data, DeviceTraits, DeviceType,
                              GraphError, Pipeline, Port, Process, ProcessChain, StreamQueue,
                              XData, stream)
from repro_torch.core.arena import (batched_layout, pack_rows, split_batched_blob,
                                    stack_host_blobs, unbatch_device, unpack_host)
from repro_torch.processes import (FFT, CombineParams, ComplexElementProd,
                                   ComplexElementProdParams, FFTParams, FusedMRIRecon,
                                   FusedReconParams, RSSCombine, SimpleMRIRecon, XImageSum)
from test_torch_compiled_launch import rec  # noqa: F401  (the recorder fixture)

SHAPE = (SMOKE.frames, SMOKE.coils, SMOKE.height, SMOKE.width)
FFT_TOL = dict(rtol=1e-6, atol=1e-6)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)


class AddConst(Process):
    batch_axis = True

    def apply(self, views, aux, params, out=None):
        c = params if params is not None else 1.0
        return {k: v + c for k, v in views.items()}


class Scale(Process):
    batch_axis = True

    def apply(self, views, aux, params, out=None):
        return {k: v * params for k, v in views.items()}


class AddAux(Process):
    batch_axis = True

    def apply(self, views, aux, params, out=None):
        return {k: v + aux["bias"]["img"] for k, v in views.items()}


class AddTwo(Process):
    """Primary input + a second input port 'rhs'."""

    batch_axis = True
    ports = {"in": Port(names=("img",)), "out": Port(names=("img",)),
             "rhs": Port(names=("img",))}

    def apply(self, views, aux, params, out=None):
        return {"img": views["img"] + aux["rhs"]["img"]}


class NoBatch(Process):
    """A process whose apply does not take the batch axis."""

    def apply(self, views, aux, params, out=None):
        return dict(views)


@pytest.fixture
def app():
    return CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))


def _img(rng, shape=(8, 8)):
    return XData({"img": rng.standard_normal(shape).astype(np.float32)})


def _host(d):
    return d.get_ndarray(0).host


def _chain(app, h_in, h_mid, h_out, mode="staged"):
    p1 = AddConst(app)
    p1.in_handle, p1.out_handle = h_in, h_mid
    p1.set_launch_parameters(1.5)
    p2 = Scale(app)
    p2.in_handle, p2.out_handle = h_mid, h_out
    p2.set_launch_parameters(-2.0)
    return ProcessChain(app, [p1, p2], mode=mode)


def _wired(app, shape=(8, 8)):
    d_in = XData({"img": np.zeros(shape, np.float32)})
    d_mid, d_out = XData(d_in, copy_values=False), XData(d_in, copy_values=False)
    return [app.addData(x) for x in (d_in, d_mid, d_out)]


def _sequential(app, proc, h_in, h_out, datasets):
    """One-at-a-time launch() reference results (host copies)."""
    out = []
    d_in = app.getData(h_in)
    for d in datasets:
        for dst, src in zip(d_in, d):
            dst.set_host(src.host)
        app.host2device(h_in)
        proc.launch()
        app.device2Host(h_out)
        out.append([a.host.copy() for a in app.getData(h_out)])
    return out


# ---------------------------------------------------------------------------
# Process.stream on plain processes (no FFT: bit for bit)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["staged", "fused"])
@pytest.mark.parametrize("batch,n", [(1, 3), (4, 8), (4, 10), (3, 7)])
def test_stream_matches_sequential_launch(app, rng, mode, batch, n):
    datasets = [_img(rng) for _ in range(n)]
    h_in, h_mid, h_out = _wired(app)
    chain = _chain(app, h_in, h_mid, h_out, mode)
    chain.init()
    want = _sequential(app, chain, h_in, h_out, datasets)
    got = chain.stream(datasets, batch=batch, sync=True)
    assert len(got) == n
    for i in range(n):
        np.testing.assert_array_equal(_host(got[i]), want[i][0], err_msg=f"dataset {i}")
        assert got[i].coherence is Coherence.IN_SYNC
    # no sync: device-fresh rows of one (rows, out_total_bytes) stack a batch
    fresh = chain.stream(datasets, batch=batch)
    assert all(d.coherence is Coherence.DEVICE_FRESH for d in fresh)
    assert all(a.host is None for d in fresh for a in d)
    np.testing.assert_array_equal(fresh[-1].device_view("img").numpy(), want[-1][0])


def test_stream_with_aux_broadcast(app, rng):
    """A static input (set_aux_handle) reaches every item unbatched."""
    bias = rng.standard_normal((8, 8)).astype(np.float32)
    h_bias = app.addData(XData({"img": bias}))
    h_in, _, h_out = _wired(app)
    p = AddAux(app)
    p.in_handle, p.out_handle = h_in, h_out
    p.set_aux_handle("bias", h_bias)
    assert p.stream_inputs() == (("in", h_in),)
    datasets = [_img(rng) for _ in range(5)]
    got = p.stream(datasets, batch=2, sync=True)
    for d, o in zip(datasets, got):
        np.testing.assert_array_equal(_host(o), _host(d) + bias)
    twin = p._stream_twins[(2, 0)].twin
    assert twin.in_handles["bias"] == h_bias       # the static input is not batched


def test_stream_in_place_chain(app, rng):
    """An in-place chain (its output is its input) streams on a batched copy
    of its input; the items' own arrays are untouched."""
    h = app.addData(XData({"img": np.zeros((8, 8), np.float32)}))
    p1, p2 = AddConst(app), Scale(app)
    p1.in_handle = p1.out_handle = p2.in_handle = p2.out_handle = h
    p1.set_launch_parameters(2.0)
    p2.set_launch_parameters(0.5)
    chain = ProcessChain(app, [p1, p2], mode="fused")
    chain.init()
    datasets = [_img(rng) for _ in range(6)]
    before = [_host(x).copy() for x in datasets]
    got = chain.stream(datasets, batch=3, sync=True)
    for b, o, x in zip(before, got, datasets):
        np.testing.assert_array_equal(_host(o), (b + 2.0) * 0.5)
        np.testing.assert_array_equal(_host(x), b)


def test_tail_policy_twins_and_padding(app, rng):
    """9 items at batch 8: waste 7/8 > 0.5, so the tail runs through a twin
    for 1 row; 10 at batch 4: waste 2/4 <= 0.5, padded (no twin for 2);
    ``tail_waste_threshold=1.0`` always pads.  Results are equal either way."""
    h_in, _, h_out = _wired(app, (3, 17))
    p = Scale(app)
    p.in_handle, p.out_handle = h_in, h_out
    p.set_launch_parameters(3.0)
    datasets = [_img(rng, (3, 17)) for _ in range(10)]
    out9 = p.stream(datasets[:9], batch=8, sync=True)
    assert sorted(p._stream_twins) == [(1, 0), (1, 1), (8, 0), (8, 1)]
    assert p._stream_twins[(1, 1)].launches == 1      # batch 1 of the stream: slot 1
    p.init()                                          # a new wiring: twins released
    assert p._stream_twins == {}
    padded = p.stream(datasets[:9], batch=8, sync=True, tail_waste_threshold=1.0)
    assert sorted(p._stream_twins) == [(8, 0), (8, 1)]
    out10 = p.stream(datasets, batch=4, sync=True)
    assert (2, 0) not in p._stream_twins and (2, 1) not in p._stream_twins
    for d, a, b in zip(datasets, out9, padded):
        np.testing.assert_array_equal(_host(a), _host(d) * 3.0)
        np.testing.assert_array_equal(_host(a), _host(b))
    for d, o in zip(datasets, out10):
        np.testing.assert_array_equal(_host(o), _host(d) * 3.0)


def test_twins_are_kept_and_released(app, rng):
    """A second stream reuses the twins (no new Data in the app); ``init()``
    takes their Data out of the app."""
    h_in, _, h_out = _wired(app)
    p = Scale(app)
    p.in_handle, p.out_handle = h_in, h_out
    p.set_launch_parameters(2.0)
    n_before = len(app._data)
    datasets = [_img(rng) for _ in range(4)]
    p.stream(datasets, batch=2)
    twins = dict(p._stream_twins)
    n_after = len(app._data)
    assert n_after > n_before
    p.stream(datasets, batch=2)
    assert p._stream_twins == twins and len(app._data) == n_after
    assert [twins[(2, s)].launches for s in (0, 1)] == [2, 2]
    p.init()
    assert len(app._data) == n_before


def test_a_process_without_the_batch_axis_is_refused(app, rng):
    h_in, _, h_out = _wired(app)
    p = NoBatch(app)
    p.in_handle, p.out_handle = h_in, h_out
    with pytest.raises(NotImplementedError, match="NoBatch cannot take a leading batch axis"):
        p.stream([_img(rng)], batch=1)
    chain = ProcessChain(app, [AddConst(app), NoBatch(app)])
    chain.stages[0].in_handle, chain.stages[0].out_handle = h_in, h_out
    chain.stages[1].in_handle, chain.stages[1].out_handle = h_out, h_out
    with pytest.raises(NotImplementedError, match=r"stages \['NoBatch'\]"):
        chain.stream([_img(rng)], batch=1)


def test_multi_device_options_raise(app, rng):
    """The multi-device options run: on an eight-lane CPU mesh the sharded,
    proportional and per-lane streams, stream-mode runs and a server equal
    launch() bit for bit (no FFT), every lane given rows.  What still
    raises is the JAX package's: an unknown split policy, and a
    proportional split or upload lanes without sharded=True."""
    from repro_torch.launch.mesh import make_data_mesh

    app.set_mesh(make_data_mesh([torch.device("cpu")] * 8))
    h_in, _, h_out = _wired(app)
    p = Scale(app)
    p.in_handle, p.out_handle = h_in, h_out
    p.set_launch_parameters(2.0)
    p.init()
    items = [_img(rng) for _ in range(16)]
    want = [w[0] for w in _sequential(app, p, h_in, h_out, items)]
    pipe = Pipeline(app) | Scale(app).bind(params=2.0)
    for kw in (dict(sharded=True), dict(sharded=True, split="proportional"),
               dict(sharded=True, lanes=True)):
        got = p.stream(items, batch=8, sync=True, **kw)
        assert p.split_vectors == [(1,) * 8] * 2
        assert sorted({key[0][0] for key in p._lane_twins}) == list(range(8))
        ran = pipe.run(items, mode="stream", batch=8, **kw)
        server = pipe.serve(batch=8, **kw)
        rids = [server.submit(x) for x in items]
        served = {r.rid: r.data for r in server.drain()}
        for i, w in enumerate(want):
            np.testing.assert_array_equal(_host(got[i]), w, err_msg=f"{kw} stream {i}")
            np.testing.assert_array_equal(_host(ran[i]), w, err_msg=f"{kw} run {i}")
            served[rids[i]].sync_to_host()
            np.testing.assert_array_equal(_host(served[rids[i]]), w, err_msg=f"{kw} serve {i}")
    with pytest.raises(ValueError, match="split policy"):
        p.stream([_img(rng)], split="uneven")
    with pytest.raises(ValueError, match="needs sharded=True"):
        p.stream([_img(rng)], split="proportional")
    with pytest.raises(ValueError, match="needs sharded=True"):
        pipe.serve(lanes=True)


def test_stream_of_stream_results_stays_on_the_device(app, rng):
    """Device-fresh results fed to a second stream are copied device to
    device into its rows (no host copy appears), with the right values."""
    h_in, _, h_out = _wired(app)
    p1 = Scale(app)
    p1.in_handle, p1.out_handle = h_in, h_out
    p1.set_launch_parameters(2.0)
    h_in2, _, h_out2 = _wired(app)
    p2 = AddConst(app)
    p2.in_handle, p2.out_handle = h_in2, h_out2
    p2.set_launch_parameters(1.0)
    datasets = [_img(rng) for _ in range(5)]
    mid = p1.stream(datasets, batch=2)
    assert all(a.host is None for d in mid for a in d)
    got = p2.stream(mid, batch=3, sync=True)
    assert all(a.host is None for d in mid for a in d)
    for d, o in zip(datasets, got):
        np.testing.assert_array_equal(_host(o), _host(d) * 2.0 + 1.0)


def test_process_stream_multi_input_mappings_and_tuples(app, rng):
    d_in = XData({"img": np.zeros((6, 6), np.float32)})
    p = AddTwo(app)
    p.in_handles["in"] = app.addData(d_in)
    p.in_handles["rhs"] = app.addData(XData(d_in, copy_values=False))
    p.out_handle = app.addData(XData(d_in, copy_values=False))
    assert [n for n, _ in p.stream_inputs()] == ["in", "rhs"]
    lhs = [_img(rng, (6, 6)) for _ in range(5)]
    rhs = [_img(rng, (6, 6)) for _ in range(5)]
    got = p.stream([{"in": a, "rhs": b} for a, b in zip(lhs, rhs)], batch=2, sync=True)
    for a, b, o in zip(lhs, rhs, got):
        np.testing.assert_array_equal(_host(o), _host(a) + _host(b))
    got2 = p.stream(list(zip(lhs, rhs)), batch=2, sync=True)
    for o, o2 in zip(got, got2):
        np.testing.assert_array_equal(_host(o), _host(o2))
    with pytest.raises(ValueError, match="streaming inputs"):
        p.stream(lhs, batch=2)                          # one Data for two inputs
    with pytest.raises(ValueError, match=r"missing \['rhs'\]"):
        p.stream([{"in": lhs[0]}], batch=2)
    with pytest.raises(ValueError, match="layout for input edge 'rhs'"):
        p.stream([(lhs[0], _img(rng, (3, 3)))], batch=2)


def test_stream_item_batch_axis_mismatch(app, rng):
    """Items must cover every input edge of a join graph; mismatches name
    the edges (as tests/test_joins.py:144)."""
    a = AddConst(app).bind(infile="x", outfile="lhs", params=1.0)
    j = AddTwo(app).bind(infile="lhs", outfile="sum", rhs="r")
    pipe = Pipeline.from_graph(app, [a, j], output="sum")
    good = {"x": _img(rng), "r": _img(rng)}
    with pytest.raises(GraphError, match="input edges"):
        pipe.run([good, _img(rng)], mode="stream", batch=2)
    with pytest.raises(GraphError, match=r"missing \['r'\]"):
        pipe.run([good, {"x": _img(rng)}], mode="stream", batch=2)
    with pytest.raises(GraphError, match="supplies 1 Data for 2"):
        pipe.run([good, (_img(rng),)], mode="stream", batch=2)
    with pytest.raises(ValueError, match="layout for input edge"):
        pipe.run([good, {"x": _img(rng, (3, 3)), "r": _img(rng)}], mode="stream", batch=2)


def test_joined_ragged_tail_is_one_twin_for_both_edges(app, rng):
    """9 items at batch 8 on a two-edge join: ONE tail twin spanning both
    edges, rows aligned; 10 at batch 4: padded, still aligned."""
    a = AddConst(app).bind(infile="x", outfile="lhs", params=1.5)
    j = AddTwo(app).bind(infile="lhs", outfile="sum", rhs="r")
    pipe = Pipeline.from_graph(app, [a, j], output="sum")
    lhs = [_img(rng, (3, 23)) for _ in range(10)]
    rhs = [_img(rng, (3, 23)) for _ in range(10)]
    items = [{"x": l_, "r": r_} for l_, r_ in zip(lhs, rhs)]
    out9 = pipe.run(items[:9], mode="stream", batch=8)
    ex = pipe.build().executor
    assert sorted(ex._stream_twins) == [(1, 0), (1, 1), (8, 0), (8, 1)]
    assert len(ex._stream_twins[(1, 0)].slots) == 2      # both edges
    out10 = pipe.run(items, mode="stream", batch=4)
    for outs in (out9, out10):
        for l_, r_, o in zip(lhs, rhs, outs):
            np.testing.assert_array_equal(_host(o), (_host(l_) + 1.5) + _host(r_))


def test_pipeline_modes_agree(app, rng):
    """launch, stream and serve over one graph: the same per-item values,
    bit for bit (no FFT), outputs in submit order."""
    pipe = Pipeline(app) | AddConst(app).bind(params=0.5) | Scale(app).bind(params=-3.0)
    datasets = [_img(rng) for _ in range(5)]
    launched = [_host(pipe.run(d)).copy() for d in datasets]
    streamed = pipe.run(datasets, mode="stream", batch=2)
    served = pipe.run(datasets, mode="serve", batch=2)
    for i in range(5):
        np.testing.assert_array_equal(_host(streamed[i]), launched[i])
        np.testing.assert_array_equal(_host(served[i]), launched[i])
    assert pipe.run([], mode="stream") == [] and pipe.run([], mode="serve") == []


# ---------------------------------------------------------------------------
# the MRI path: the port's sequential launch() and the JAX package
# ---------------------------------------------------------------------------

def _slices(n, seed=50):
    """``n`` slices, each with its own k-space and its own maps."""
    rng = np.random.default_rng(seed)
    f, c, h, w = SHAPE
    out = []
    for _ in range(n):
        k = (rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)
        s = (rng.standard_normal((c, h, w)) + 1j * rng.standard_normal((c, h, w))
             ).astype(np.complex64)
        out.append((k, s))
    return out


def _kd(mod, k, s):
    return mod.KData({"kdata": k.copy(), "sensitivity_maps": s.copy()})


def _recon(mod, app, cls, k0, s0, out_dtype=np.complex64, **kw):
    h_in = app.addData(_kd(mod, k0, s0))
    f, _, h, w = SHAPE
    h_out = app.addData(mod.XData({"xdata": np.zeros((f, h, w), out_dtype)}))
    p = cls(app, **kw)
    p.in_handle, p.out_handle = h_in, h_out
    return p, h_in, h_out


@pytest.mark.parametrize("mode", ["staged", "fused", "fused_kernel"])
@pytest.mark.parametrize("in_place", [True, False])
@pytest.mark.parametrize("batch,n", [(1, 2), (2, 4), (2, 5), (3, 7)])
def test_simple_mri_recon_stream_matches_sequential_launch(app, mode, in_place, batch, n):
    """Batch 1, 2 and 3 with no tail (2 at 1, 4 at 2), a padded tail (5 at
    2) and a tail twin (7 at 3), in every mode, in place or not: each item
    against the port's sequential launch() (rtol 1e-6: each batch is one
    FFT call on the CPU too)."""
    sl = _slices(n)
    p, h_in, h_out = _recon(tcore, app, SimpleMRIRecon, *sl[0], mode=mode, in_place=in_place)
    p.init()
    items = [_kd(tcore, k, s) for k, s in sl]
    want = _sequential(app, p, h_in, h_out, items)
    got = p.stream(items, batch=batch, sync=True)
    for i in range(n):
        np.testing.assert_allclose(_host(got[i]), want[i][0], **FFT_TOL, err_msg=f"slice {i}")
    twins = sorted(p.chain._stream_twins)
    tail_twin = n % batch and (batch - n % batch) / batch > 0.5
    assert twins == sorted({(batch, 0), (batch, 1)} | ({(n % batch, 0), (n % batch, 1)}
                                                        if tail_twin else set()))


JMODE = {"staged": "staged", "fused": "fused", "fused_kernel": "fused_pallas"}


@pytest.mark.parametrize("mode", ["staged", "fused", "fused_kernel"])
@pytest.mark.parametrize("batch,n", [(2, 5), (3, 7)])
def test_simple_mri_recon_stream_matches_jax(app, mode, batch, n):
    """SimpleMRIRecon.stream against the JAX package's SimpleMRIRecon.stream
    (the port's fused_kernel is the reference's fused_pallas), a padded
    tail and a tail twin, at rtol 1e-4."""
    sl = _slices(n, seed=60)
    japp = jcore.CLapp().init()
    jp, _, _ = _recon(jcore, japp, jproc.SimpleMRIRecon, *sl[0], mode=JMODE[mode],
                      in_place=False)
    jp.init()
    want = jp.stream([_kd(jcore, k, s) for k, s in sl], batch=batch, sync=True)
    p, _, _ = _recon(tcore, app, SimpleMRIRecon, *sl[0], mode=mode, in_place=False)
    got = p.stream([_kd(tcore, k, s) for k, s in sl], batch=batch, sync=True)
    for i in range(n):
        np.testing.assert_allclose(_host(got[i]), np.asarray(_host(want[i])), **JAX_TOL,
                                   err_msg=f"slice {i}")


def test_rss_streams_match_jax(app):
    """RSS: FusedMRIRecon(combine="rss") and the FFT > ComplexElementProd >
    RSSCombine chain streamed, against the JAX FusedMRIRecon(combine="rss")
    stream (rtol 1e-4) and the port's own sequential launches."""
    sl = _slices(5, seed=70)
    japp = jcore.CLapp().init()
    jp, _, _ = _recon(jcore, japp, jproc.FusedMRIRecon, *sl[0], out_dtype=np.float32)
    jp.set_launch_parameters(JFusedReconParams(combine="rss"))
    jp.init()
    want = [np.asarray(_host(o)) for o in jp.stream([_kd(jcore, k, s) for k, s in sl],
                                                    batch=2, sync=True)]
    p, h_in, h_out = _recon(tcore, app, FusedMRIRecon, *sl[0], out_dtype=np.float32)
    p.set_launch_parameters(FusedReconParams(combine="rss"))
    p.init()
    items = [_kd(tcore, k, s) for k, s in sl]
    seq = _sequential(app, p, h_in, h_out, items)
    got = p.stream(items, batch=2, sync=True)
    # the staged chain with the rss coil combination
    h_in2 = app.addData(_kd(tcore, *sl[0]))
    h_work = app.addData(app.getData(h_in2).spec_clone())
    h_out2 = app.addData(XData({"xdata": np.zeros(want[0].shape, np.float32)}))
    p_fft, p_prod, p_rss = FFT(app), ComplexElementProd(app), RSSCombine(app)
    p_fft.in_handle, p_fft.out_handle = h_in2, h_work
    p_fft.set_launch_parameters(FFTParams("backward", var="kdata"))
    p_prod.in_handle = p_prod.out_handle = h_work
    p_prod.set_launch_parameters(ComplexElementProdParams(conjugate=True))
    p_rss.in_handle, p_rss.out_handle = h_work, h_out2
    chain = ProcessChain(app, [p_fft, p_prod, p_rss], mode="staged")
    got_chain = chain.stream(items, batch=3, sync=True)
    for i in range(5):
        np.testing.assert_allclose(_host(got[i]), want[i], **JAX_TOL)
        np.testing.assert_allclose(_host(got[i]), seq[i][0], **FFT_TOL)
        np.testing.assert_allclose(_host(got_chain[i]), want[i], **JAX_TOL)


def _items(mod, k, s):
    return {"kspace": mod.Data({"kdata": k.copy()}),
            "smaps": mod.Data({"sensitivity_maps": s.copy()})}


def _mri_graph(mod, procs, params, app, smaps=None):
    """The fan-in graph (smaps=None: maps a second input edge) or the graph
    with the maps bound statically, in either package."""
    fft_p, prod_p, comb_p = params
    fft = procs.FFT(app).bind(infile="kspace", outfile="xspace",
                              params=fft_p("backward", var="kdata"))
    prod = procs.ComplexElementProd(app).bind(
        infile="xspace", outfile="weighted", smaps="smaps" if smaps is None else smaps,
        params=prod_p(conjugate=True))
    comb = procs.XImageSum(app).bind(infile="weighted", outfile="image", params=comb_p())
    return mod.Pipeline.from_graph(app, [comb, fft, prod], output="image")


TORCH = (tcore, tproc, (FFTParams, ComplexElementProdParams, CombineParams))
JAX = (jcore, jproc, (JFFTParams, JComplexElementProdParams, JCombineParams))


def test_join_three_modes_bit_identical_to_aux_and_match_jax(app):
    """Shared maps: the fan-in graph equals the graph with the maps bound
    statically, bit for bit, in launch, stream (5 at batch 2: a padded
    tail) and serve; and the streamed join matches the JAX package's."""
    sl = _slices(5, seed=80)
    s0 = sl[0][1]
    join = _mri_graph(*TORCH[:2], TORCH[2], app)
    aux = _mri_graph(*TORCH[:2], TORCH[2], app, smaps=Data({"sensitivity_maps": s0}))
    assert join.input_edges == ("kspace", "smaps") and aux.input_edges == ("kspace",)
    kst = [Data({"kdata": k}) for k, _ in sl]
    items = [_items(tcore, k, s0) for k, _ in sl]
    want_launch = [_host(aux.run(d)).copy() for d in kst]
    want_stream = aux.run(kst, mode="stream", batch=2)
    got_stream = join.run(items, mode="stream", batch=2)
    got_serve = join.run(items, mode="serve", batch=2)
    for i in range(5):
        np.testing.assert_array_equal(_host(join.run(items[i])), want_launch[i])
        np.testing.assert_array_equal(_host(got_stream[i]), _host(want_stream[i]))
        np.testing.assert_array_equal(_host(got_serve[i]), _host(want_stream[i]))
        np.testing.assert_allclose(_host(got_stream[i]), want_launch[i], **FFT_TOL)
    japp = jcore.CLapp().init()
    jjoin = _mri_graph(*JAX[:2], JAX[2], japp)
    jwant = jjoin.run([_items(jcore, k, s0) for k, _ in sl], mode="stream", batch=2)
    for i in range(5):
        np.testing.assert_allclose(_host(got_stream[i]), np.asarray(_host(jwant[i])), **JAX_TOL)


def test_join_streams_per_item_maps(app):
    """Per-item maps through the smaps edge (one map set a slice in the
    product): each item against the single-arena graph streamed (the maps
    in the KData), bit for bit, and against the JAX package's join."""
    sl = _slices(4, seed=90)
    join = _mri_graph(*TORCH[:2], TORCH[2], app)
    arena = (Pipeline(app) | FFT(app).bind(infile="kspace", outfile="xspace",
                                           params=FFTParams("backward", var="kdata"))
             | ComplexElementProd(app).bind(params=ComplexElementProdParams(conjugate=True))
             | XImageSum(app).bind(params=CombineParams()))
    got = join.run([_items(tcore, k, s) for k, s in sl], mode="stream", batch=3)
    want = arena.run([_kd(tcore, k, s) for k, s in sl], mode="stream", batch=3)
    japp = jcore.CLapp().init()
    jwant = _mri_graph(*JAX[:2], JAX[2], japp).run([_items(jcore, k, s) for k, s in sl],
                                                    mode="stream", batch=3)
    for i in range(4):
        np.testing.assert_array_equal(_host(got[i]), _host(want[i]))
        np.testing.assert_allclose(_host(got[i]), np.asarray(_host(jwant[i])), **JAX_TOL)


@pytest.mark.parametrize("mode", ["staged", "fused_kernel"])
def test_joined_simple_mri_recon_streams_by_its_port_names(app, mode):
    """SimpleMRIRecon(join=True) streamed directly with {"in", "smaps"}
    mappings (the chain's input names), per-item maps, against the single-
    arena SimpleMRIRecon streamed (bit for bit) and the JAX package's
    joined composite (rtol 1e-4)."""
    sl = _slices(3, seed=95)
    f, _, h, w = SHAPE
    recon = SimpleMRIRecon(app, mode=mode, in_place=False, join=True)
    recon.in_handles["in"] = app.addData(Data({"kdata": sl[0][0].copy()}))
    recon.in_handles["smaps"] = app.addData(Data({"sensitivity_maps": sl[0][1].copy()}))
    recon.out_handle = app.addData(XData({"xdata": np.zeros((f, h, w), np.complex64)}))
    recon.init()
    assert [n for n, _ in recon.chain.stream_inputs()] == ["in", "smaps"]
    got = recon.stream([{"in": Data({"kdata": k}), "smaps": Data({"sensitivity_maps": s})}
                        for k, s in sl], batch=2, sync=True)
    single, _, _ = _recon(tcore, app, SimpleMRIRecon, *sl[0], mode=mode, in_place=False)
    want = single.stream([_kd(tcore, k, s) for k, s in sl], batch=2, sync=True)
    japp = jcore.CLapp().init()
    jpipe = jcore.Pipeline.from_graph(japp, [jproc.SimpleMRIRecon(
        japp, mode=JMODE[mode], in_place=False, join=True).bind(infile="kspace", smaps="smaps")])
    jwant = jpipe.run([_items(jcore, k, s) for k, s in sl], mode="stream", batch=2)
    for i in range(3):
        np.testing.assert_array_equal(_host(got[i]), _host(want[i]))
        np.testing.assert_allclose(_host(got[i]), np.asarray(_host(jwant[i])), **JAX_TOL)


# ---------------------------------------------------------------------------
# the upload ring: StreamQueue bookkeeping and the stream seam
# ---------------------------------------------------------------------------

def test_stream_queue_prefetch_depth_and_sync():
    """``depth`` counts upload slots: after the first item is handed out,
    it and one more are uploaded (depth 2: one in use, one in flight); on
    the CPU every copy is synchronous, so nothing stays in flight."""
    blobs = [np.full((16,), i, np.uint8) for i in range(5)]
    q = StreamQueue(iter(blobs), depth=2)
    first = next(q)
    assert q.transfers == 2
    np.testing.assert_array_equal(first.numpy(), blobs[0])
    rest = [t.numpy().copy() for t in q]
    assert len(rest) == 4 and q.transfers == 5
    for want, got in zip(blobs[1:], rest):
        np.testing.assert_array_equal(got, want)
    assert q.in_flight == 0
    q.sync()
    with pytest.raises(ValueError, match="depth"):
        StreamQueue([], depth=0)
    floats = [np.full((3, 4), i, np.float32) for i in range(3)]
    got = [t.clone() for t in StreamQueue(floats, depth=3)]
    assert all(torch.equal(g, torch.from_numpy(f)) for g, f in zip(got, floats))


class FakeStreams:
    """Stands in for ``stream._DeviceStreams``: every operation runs at once
    and is logged; events are numbers."""

    def __init__(self):
        self.log = []
        self.n = 0

    def _event(self, kind):
        self.n += 1
        self.log.append((kind, self.n))
        return self.n

    def compute_event(self):
        return self._event("record_compute")

    def copy_event(self):
        return self._event("record_copy")

    def copy_waits(self, ev):
        self.log.append(("copy_waits", ev))

    def copy_waits_compute(self):
        self.log.append(("copy_waits_compute", None))

    def compute_waits(self, ev):
        self.log.append(("compute_waits", ev))

    def host_waits(self, ev):
        self.log.append(("host_waits", ev))

    def on_copy(self):
        return contextlib.nullcontext()

    def upload(self, dev, host):
        self.log.append(("upload", (dev.data_ptr(), host.data_ptr())))
        dev.copy_(host)

    def pinned(self, nbytes):
        return torch.empty(nbytes, dtype=torch.uint8)

    def synchronize(self):
        self.log.append(("synchronize", None))


def test_upload_ring_order_and_compiled_twins(rec, app, monkeypatch):
    """Through a recorder in the stream seam, with launches compiled as on
    the card (the recorder of test_torch_compiled_launch): 11 slices at
    batch 2 (5 batches and a padded tail) twice, and 5 at batch 3 (a tail
    twin).  Every upload into a slot waits on an event recorded after the
    last launch that read the slot; every refill of a pinned buffer waits
    (on the host) for that buffer's last copy; every launch waits for the
    copies into its slots; each twin (rows, slot) is eager once, captured
    at its second launch and replayed after; no replay reads a blob that
    moved (the recorder fails it)."""
    fake = FakeStreams()
    monkeypatch.setattr(stream, "_streams_for", lambda device, copy=None: fake)
    launched = BatchedProcess.__call__

    def logged(bp):
        fake.log.append(("launch", tuple(s.dev.data_ptr() for s in bp.slots)))
        return launched(bp)
    monkeypatch.setattr(BatchedProcess, "__call__", logged)
    sl = _slices(11, seed=7)
    p, h_in, h_out = _recon(tcore, app, SimpleMRIRecon, *sl[0], mode="staged", in_place=False)
    p.init()
    items = [_kd(tcore, k, s) for k, s in sl]
    seq = _sequential(app, p, h_in, h_out, items)
    for run, (batch, n) in enumerate(((2, 11), (2, 11), (3, 5))):
        got = p.stream(items[:n], batch=batch, sync=True)
        for i in range(n):
            np.testing.assert_allclose(_host(got[i]), seq[i][0], **FFT_TOL,
                                       err_msg=f"run {run} slice {i}")
    log = fake.log
    copies_of, last_launch, last_copy_of_host = {}, {}, {}
    for i, (kind, arg) in enumerate(log):
        if kind == "launch":
            waits = [a for k, a in log[:i] if k == "compute_waits"]
            for ptr in arg:
                assert copies_of[ptr] in waits      # the launch waited for its slot's copy
                last_launch[ptr] = i
        elif kind == "upload":
            dev, host = arg
            waited = log[i - 1]
            assert waited[0] == "copy_waits"
            if dev in last_launch:      # read before: wait for a mark after that launch
                marks = [j for j, (k, a) in enumerate(log) if k == "record_compute"
                         and a == waited[1]]
                assert marks and marks[0] > last_launch[dev], f"upload at {i} races a launch"
            if host in last_copy_of_host:
                host_waits = [a for k, a in log[:i] if k == "host_waits"]
                assert host_waits[-1] == last_copy_of_host[host]
            assert log[i + 1][0] == "record_copy"
            copies_of[dev] = last_copy_of_host[host] = log[i + 1][1]
    twins = p.chain._stream_twins
    assert sorted(twins) == [(2, 0), (2, 1), (3, 0), (3, 1)]
    for key, bp in twins.items():
        assert (bp.captures, bp.replays) == (int(bp.launches >= 2), max(bp.launches - 1, 0)), key
    assert [twins[k].launches for k in sorted(twins)] == [6, 6, 1, 1]
    # the sequential launches' chain captured once too
    assert rec.events.count("capture") == 2 + 1 and p.chain.captures == 1


# ---------------------------------------------------------------------------
# the arena's batch helpers
# ---------------------------------------------------------------------------

def test_batched_layout_and_row_helpers(rng):
    d = Data({"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.integers(0, 9, (5,)).astype(np.int32)})
    d.plan()
    items = [Data({"a": rng.standard_normal((3, 4)).astype(np.float32),
                   "b": rng.integers(0, 9, (5,)).astype(np.int32)}) for _ in range(3)]
    for x in items:
        x.plan()
    lay = batched_layout(d.layout, 3)
    assert [e.shape for e in lay.entries] == [(3, 3, 4), (3, 5)]
    host = np.zeros(lay.total_bytes, np.uint8)
    pack_rows(host, lay, [{a.name: a.host for a in x} for x in items])
    views = unpack_host(host, lay)
    np.testing.assert_array_equal(views["a"][1], items[1].get_ndarray(0).host)
    stacked = unbatch_device(torch.from_numpy(host), lay, d.layout)
    assert tuple(stacked.shape) == (3, d.layout.total_bytes)
    rows = split_batched_blob(stacked)
    for r, x in zip(rows, items):
        np.testing.assert_array_equal(r.numpy(), x.pack_host())
    np.testing.assert_array_equal(stack_host_blobs([x.pack_host() for x in items], d.layout),
                                  stacked.numpy())
    with pytest.raises(ValueError, match="does not match layout"):
        stack_host_blobs([np.zeros(3, np.uint8)], d.layout)
    spec = Data.from_layout(d.layout)
    assert spec.names == d.names and spec.layout == d.layout
    assert all(a.host is None for a in spec)


# ---------------------------------------------------------------------------
# the port's MRI example with --stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--stream", "5", "--batch", "2"],
                                  ["--kernel", "--pipeline", "--join", "--stream", "4",
                                   "--batch", "3"]])
def test_mri_recon_example_streams_at_smoke_size(app, tmp_path, argv):
    """``--stream N --batch K`` on a CPU app at SMOKE size: N slices streamed
    twice, the last against launch() (the example checks it) and the
    oracle; the twins' launches add up to twice the batches."""
    from repro_torch.launch import mri_recon

    res = mri_recon.main(argv + ["--out", str(tmp_path / "o.npz")], app=app, cfg=SMOKE)
    st = res["stream"]
    n, k = int(argv[argv.index("--stream") + 1]), int(argv[argv.index("--batch") + 1])
    assert (st["n"], st["batch"]) == (n, k) and st["max_abs_err"] < 1e-4
    assert sum(st["launches"].values()) == 2 * -(-n // k)
    assert st["exact"] == ("--kernel" in argv)
    if "--pipeline" in argv:
        assert res["pipeline"]["stream_max_abs_err"] < 1e-4
        assert res["join"]["serve_p99_ms"] >= res["join"]["serve_p50_ms"] > 0


@pytest.mark.parametrize("flag", ["--sharded", "--proportional"])
def test_mri_recon_example_refuses_the_multi_device_stream(app, tmp_path, flag):
    """``--stream 4 --sharded`` and ``--proportional`` (which implies
    ``--sharded``) run on an eight-lane CPU mesh at SMOKE size: the example
    holds the last slice against launch() (within 1e-6: the FFT) and the
    oracle; four slices padded to a batch of 8 give every lane one row."""
    from repro_torch.launch import mri_recon
    from repro_torch.launch.mesh import make_data_mesh

    app.set_mesh(make_data_mesh([torch.device("cpu")] * 8))
    res = mri_recon.main(["--stream", "4", "--batch", "8", flag,
                          "--out", str(tmp_path / "o.npz")], app=app, cfg=SMOKE)
    st = res["stream"]
    assert st["max_abs_err"] < 1e-4 and res["max_abs_err"] < 1e-4
    assert st["vectors"] == [(1,) * 8] and st["lane_rows"] == [1] * 8
    assert st["lane_twins"] == {j: 2 for j in range(8)}      # rows 1, two upload slots
    assert sum(st["launches"].values()) == 2 * 8              # two streams, 8 lanes
    if flag == "--proportional":
        assert all(r > 0 for r in st["rates"])
