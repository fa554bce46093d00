"""Multi-lane streams of the port on an eight-lane CPU mesh: the port's
counterpart of the ``@needs_8_devices`` tests of ``tests/test_mesh_stream.py``
that cover the data and model axes of the MRI path (sharded, proportional,
per-lane, joins, serves, divisibility, zero-rate exclusion, an uneven
tail, one transfer record a lane, the twins' keys, the 2D recon in three
modes), and its parity with the JAX package's forced-eight-device run.

The JAX tests get eight devices from ``XLA_FLAGS``; the port's mesh names
the one CPU eight times (``make_data_mesh([cpu] * 8)``), which gives eight
lanes, each with its own app, twins and upload queue.  Every lane is the
one CPU, so "spread" is shown by the rows each lane was given (the
stream's split vectors) and the twins each lane holds.

Tolerances: bit for bit against ``launch()`` where no FFT runs and for the
kernel mode; rtol/atol 1e-6 where a batch goes through one FFT call (the
JAX package's caveat); against the JAX package, rtol/atol 1e-4
(``docs/kernels.md`` §3), split vectors exactly.
"""
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.mri_recon import SMOKE
from repro_torch.core import (BatchedProcess, CLapp, DeviceTraits, DeviceType, KData, Pipeline,
                              Port, Process, ProcessChain, ProfileParameters, XData)
from repro_torch.core import process as tprocess
from repro_torch.launch.mesh import DeviceProfileRegistry, make_data_mesh
from repro_torch.processes import SimpleMRIRecon
from test_torch_compiled_launch import rec  # noqa: F401  (the recorder fixture)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
FFT_TOL = dict(rtol=1e-6, atol=1e-6)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)


class Scale(Process):
    batch_axis = True

    def apply(self, views, aux, params, out=None):
        return {k: v * params for k, v in views.items()}


class AddAux(Process):
    batch_axis = True
    ports = {"in": Port(), "out": Port(), "bias": Port(names=("img",))}

    def apply(self, views, aux, params, out=None):
        return {k: v + aux["bias"]["img"] for k, v in views.items()}


class MulTwo(Process):
    """Two streamed inputs: ``in`` times the ``rhs`` edge."""

    batch_axis = True
    ports = {"in": Port(names=("img",)), "out": Port(names=("img",)),
             "rhs": Port(names=("img",))}

    def apply(self, views, aux, params, out=None):
        return {"img": views["img"] * aux["rhs"]["img"]}


def _cpu_app(lanes=8, model=1):
    app = CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))
    if lanes > 1 or model > 1:
        app.set_mesh(make_data_mesh([CPU] * lanes, model=model))
    return app


@pytest.fixture
def app():
    return _cpu_app()


def _mk(rng, n, shape=(8, 8)):
    return [XData({"img": rng.standard_normal(shape).astype(np.float32)}) for _ in range(n)]


def _host(d):
    if d.get_ndarray(0).host is None:
        d.sync_to_host()
    return d.get_ndarray(0).host


def _scale(app, params=-1.5, shape=(8, 8)):
    d_in = XData({"img": np.zeros(shape, np.float32)})
    p = Scale(app)
    p.in_handle, p.out_handle = app.addData(d_in), app.addData(XData(d_in, copy_values=False))
    p.set_launch_parameters(params)
    p.init()
    return p


def _lane_rows(target, n=8):
    """Rows each lane was given over the last multi-lane stream."""
    return [sum(v[j] for v in target.split_vectors) for j in range(n)]


def _lane_twins(target):
    out = {}
    for key in target._lane_twins:
        out[key[0][0]] = out.get(key[0][0], 0) + 1
    return out


def _equal(got, want, what="item"):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_host(g), w, err_msg=f"{what} {i}")


# ---------------------------------------------------------------------------
# the equal split (sharded=True)
# ---------------------------------------------------------------------------

def test_sharded_stream_bit_identical_and_spread(app, rng):
    p = _scale(app)
    data = _mk(rng, 16)
    want = [_host(d) * np.float32(-1.5) for d in data]
    bp = BatchedProcess(p, 8, sharded=True).init()
    assert bp.batch_sharding.spec == ("data",) and bp.batch_sharding.mesh == app.mesh
    assert [part.batch for part in bp.parts] == [1] * 8
    got = p.stream(data, batch=8, sharded=True, sync=True)
    _equal(got, want)
    assert p.split_vectors == [(1,) * 8] * 2
    assert _lane_rows(p) == [2] * 8                 # every lane computed its share
    assert _lane_twins(p) == {j: 2 for j in range(8)}  # rows 1, two upload slots
    assert all(o.device_blob.device == CPU for o in got)


def test_sharded_stream_aux_replicated(app, rng):
    """A static input is replicated onto every lane once a stream; the
    root Data keeps its blob, later unsharded launches and streams still
    read it, and a new value reaches the lanes at the next stream."""
    bias = rng.standard_normal((8, 8)).astype(np.float32)
    d_bias = XData({"img": bias})
    h_bias = app.addData(d_bias)
    blob = d_bias.device_blob
    d_in = XData({"img": np.zeros((8, 8), np.float32)})
    p = AddAux(app)
    p.in_handle, p.out_handle = app.addData(d_in), app.addData(XData(d_in, copy_values=False))
    p.set_aux_handle("bias", h_bias)
    data = _mk(rng, 8)
    _equal(p.stream(data, batch=8, sharded=True, sync=True), [_host(d) + bias for d in data])
    assert d_bias.device_blob is blob
    lanes = app._stream_lanes.values()
    assert len(lanes) == 8 and all(h_bias in lane.replicas for lane in lanes)
    p.init()
    p.launch()
    _equal(p.stream(data[:4], batch=2, sync=True), [_host(d) + bias for d in data[:4]])
    d_bias.get_ndarray(0).set_host(bias * 2)
    app.host2device(h_bias)
    _equal(p.stream(data, batch=8, sharded=True, sync=True),
           [_host(d) + 2 * bias for d in data], "refreshed")


def test_sharded_in_place_chain_donation(app, rng):
    d = XData({"img": np.zeros((8, 8), np.float32)})
    h = app.addData(d)
    p1, p2 = Scale(app), Scale(app)
    for p, c in ((p1, 2.0), (p2, 0.5)):
        p.in_handle = p.out_handle = h
        p.set_launch_parameters(c)
    chain = ProcessChain(app, [p1, p2], mode="fused")
    chain.init()
    data = _mk(rng, 8)
    for x, o in zip(data, chain.stream(data, batch=8, sharded=True, sync=True)):
        np.testing.assert_allclose(_host(o), _host(x), rtol=1e-6)


def test_sharded_batch_divisibility_enforced(app, rng):
    p = _scale(app, 1.0)
    with pytest.raises(ValueError, match="divisible"):
        p.stream(_mk(rng, 6), batch=3, sharded=True)
    with pytest.raises(ValueError, match="divisible"):
        BatchedProcess(p, 3, sharded=True).init()
    with pytest.raises(ValueError, match="mutually"):
        BatchedProcess(p, 2, sharded=True, device=CPU)
    with pytest.raises(ValueError, match="mutually"):
        BatchedProcess(p, 2, device=CPU, group=(CPU, CPU))
    # a tail the lane count does not divide is padded (every lane whole items)
    data = _mk(rng, 12)
    got = p.stream(data, batch=8, sharded=True, sync=True, tail_waste_threshold=0.0)
    _equal(got, [_host(d) for d in data])
    assert p.split_vectors == [(1,) * 8] * 2


def test_lane_twins_are_keyed_by_lane_and_mesh(rng):
    """Two lanes never share a twin: twins are kept by (lane, rows, slot),
    the lane being its position and its model group; a stream over the
    same mesh again reuses them (the JAX compile cache's hit), a mesh whose
    groups differ sets up its own (its miss), and a one-lane app keeps the
    one-device (rows, slot) twins."""
    app = _cpu_app()
    p = _scale(app)
    data = _mk(rng, 8)
    p.stream(data, batch=8, sharded=True)
    keys = set(p._lane_twins)
    assert len(keys) == 16 and len({key[0] for key in keys}) == 8
    twins = {k: bp.twin for k, bp in p._lane_twins.items()}
    assert len({id(t) for t in twins.values()}) == 16
    assert len({id(t.getApp()) for t in twins.values()}) == 8    # an app a lane
    p.stream(data, batch=8, sharded=True)
    assert set(p._lane_twins) == keys and all(p._lane_twins[k].twin is twins[k] for k in keys)
    app.set_mesh(make_data_mesh([CPU] * 8, model=2))
    p.stream(data, batch=8, sharded=True)
    grouped = set(p._lane_twins) - keys
    assert {key[0] for key in grouped} == {(j, ("cpu", "cpu")) for j in range(4)}
    one = _cpu_app(lanes=1)
    q = _scale(one)
    q.stream(data, batch=8, sharded=True)
    assert q._lane_twins == {} and sorted(q._stream_twins) == [(8, 0), (8, 1)]


def test_sharded_joined_stream_bit_identical_and_spread(app, rng):
    a = Scale(app).bind(infile="x", outfile="lhs", params=2.0)
    j = MulTwo(app).bind(infile="lhs", outfile="prod", rhs="r")
    pipe = Pipeline.from_graph(app, [a, j], output="prod")
    lhs, rhs = _mk(rng, 16), _mk(rng, 16)
    items = [{"x": l, "r": r} for l, r in zip(lhs, rhs)]
    want = [_host(l) * 2 * _host(r) for l, r in zip(lhs, rhs)]
    _equal(pipe.run(items, mode="stream", batch=8, sharded=True), want)
    assert _lane_rows(pipe.build().executor) == [2] * 8
    _equal(pipe.run(items, mode="serve", batch=8, sharded=True), want, "served")


# ---------------------------------------------------------------------------
# split="proportional"
# ---------------------------------------------------------------------------

def test_proportional_stream_bit_identical_and_spread(app, rng):
    p = _scale(app)
    data = _mk(rng, 32)
    eq = p.stream(data, batch=16, sharded=True, sync=True)
    assert not app.device_profiles.warm(range(8))           # the equal split records none
    pr = p.stream(data, batch=16, sharded=True, split="proportional", sync=True)
    _equal(pr, [_host(e) for e in eq])
    assert p.split_vectors[0] == (2,) * 8                     # cold: balanced
    assert all(r > 0 for r in _lane_rows(p))
    assert app.device_profiles.warm(range(8))
    prof = app.device_profiles.profile(3)
    assert prof.items >= 2 and prof.rate > 0 and len(prof.seconds.samples) >= 1
    assert app._pending_rates == []


def test_proportional_skewed_allocation(app, rng):
    """Set rates steer rows: the slow lane gets far fewer than its share,
    a zero-rate lane none, and the outputs equal the equal split's."""
    app.device_profiles = DeviceProfileRegistry(ema=0.0)    # the set rates stay
    app.device_profiles.set_rate(0, 1.0)
    for j in range(1, 8):
        app.device_profiles.set_rate(j, 7.0)
    assert app.device_profiles.split(50, range(8)) == (1, 7, 7, 7, 7, 7, 7, 7)
    p = _scale(app, 2.5)
    data = _mk(rng, 32)
    eq = p.stream(data, batch=16, sharded=True, sync=True)
    pr = p.stream(data, batch=16, sharded=True, split="proportional", sync=True)
    _equal(pr, [_host(e) for e in eq])
    assert p.split_vectors == [(1, 3, 2, 2, 2, 2, 2, 2)] * 2   # 16/50 of the 50-row carve
    app.device_profiles.set_rate(0, 0.0)
    pr = p.stream(data, batch=16, sharded=True, split="proportional", sync=True)
    _equal(pr, [_host(e) for e in eq], "zero-rate")
    assert _lane_rows(p)[0] == 0 and all(r > 0 for r in _lane_rows(p)[1:])


def test_proportional_joined_stream_shares_split_vector(app, rng):
    app.device_profiles = DeviceProfileRegistry(ema=0.0)
    app.device_profiles.set_rate(0, 1.0)
    for j in range(1, 8):
        app.device_profiles.set_rate(j, 3.0)
    a = Scale(app).bind(infile="x", outfile="lhs", params=2.0)
    j = MulTwo(app).bind(infile="lhs", outfile="prod", rhs="r")
    pipe = Pipeline.from_graph(app, [a, j], output="prod")
    lhs, rhs = _mk(rng, 32), _mk(rng, 32)
    items = [{"x": l, "r": r} for l, r in zip(lhs, rhs)]
    want = [_host(l) * 2 * _host(r) for l, r in zip(lhs, rhs)]
    _equal(pipe.run(items, mode="stream", batch=16, sharded=True, split="proportional"), want)
    assert pipe.build().executor.split_vectors == [(1, 3, 2, 2, 2, 2, 2, 2)] * 2
    _equal(pipe.run(items, mode="serve", batch=16, sharded=True, split="proportional"), want,
           "served")


def test_zero_rate_device_excluded_from_balanced_fallback(app, rng):
    """A lane set at rate 0 gets no rows even when the split falls back to
    balanced (a small batch, cold peers)."""
    app.device_profiles.set_rate(0, 0.0)
    p = _scale(app, 3.0)
    data = _mk(rng, 8)
    got = p.stream(data, batch=8, sharded=True, split="proportional", sync=True)
    _equal(got, [_host(d) * 3.0 for d in data])
    assert p.split_vectors == [(0, 2, 1, 1, 1, 1, 1, 1)]
    # lane 0's twins of the balanced vector were set up, and never launched
    assert all(bp.launches == 0 for key, bp in p._lane_twins.items() if key[0][0] == 0)


def test_proportional_uneven_batch_allowed(app, rng):
    p = _scale(app, 0.5)
    data = _mk(rng, 12)
    with pytest.raises(ValueError, match="divisible"):
        p.stream(data, batch=6, sharded=True)
    want = p.stream(data, batch=6, sync=True)
    got = p.stream(data, batch=6, sharded=True, split="proportional", sync=True)
    _equal(got, [_host(w) for w in want])
    assert p.split_vectors[0] == (1, 1, 1, 1, 1, 1, 0, 0)


def test_proportional_uneven_tail_and_all_zero_rates(app, rng):
    """An exact tail of 3 under the proportional split; every lane at rate
    0 is degenerate and balances over the whole pool."""
    p = _scale(app, -2.0)
    data = _mk(rng, 19)
    got = p.stream(data, batch=16, sharded=True, split="proportional",
                   tail_waste_threshold=0.0, sync=True)
    _equal(got, [_host(d) * -2.0 for d in data])
    assert [sum(v) for v in p.split_vectors] == [16, 3]
    for j in range(8):
        app.device_profiles.set_rate(j, 0.0)
    got = p.stream(data[:4], batch=4, sharded=True, split="proportional", sync=True)
    _equal(got, [_host(d) * -2.0 for d in data[:4]])
    assert p.split_vectors == [(1, 1, 1, 1, 0, 0, 0, 0)]


def test_proportional_background_drain(app, rng):
    pipe = Pipeline(app) | Scale(app).bind(params=-1.0)
    data = _mk(rng, 5)
    with pipe.serve(batch=4, sharded=True, split="proportional", flush_timeout=0.01) as server:
        rids = [server.submit(d) for d in data]
        responses = server.collect(len(rids), timeout=30.0)
    by_rid = {r.rid: r.data for r in responses}
    _equal([by_rid[r] for r in rids], [-_host(d) for d in data])
    assert app._pending_rates == []                       # every launch's rate was read


# ---------------------------------------------------------------------------
# lanes=True
# ---------------------------------------------------------------------------

def test_lanes_require_sharded(app, rng):
    p = _scale(app)
    with pytest.raises(ValueError, match="sharded"):
        p.stream(_mk(rng, 4), batch=2, lanes=True)


def test_lanes_stream_bit_identical_and_spread(app, rng):
    p = _scale(app)
    data = _mk(rng, 16)
    _equal(p.stream(data, batch=8, sharded=True, lanes=True, sync=True),
           [_host(d) * np.float32(-1.5) for d in data])
    assert _lane_rows(p) == [2] * 8 and _lane_twins(p) == {j: 2 for j in range(8)}


def test_lanes_lift_batch_divisibility(app, rng):
    p = _scale(app, 2.5)
    data = _mk(rng, 6)
    with pytest.raises(ValueError, match="divisible"):
        p.stream(data, batch=3, sharded=True)
    want = p.stream(data, batch=3, sync=True)
    _equal(p.stream(data, batch=3, sharded=True, lanes=True, sync=True),
           [_host(w) for w in want])
    assert p.split_vectors == [(1, 1, 1, 0, 0, 0, 0, 0)] * 2


def test_lanes_transfer_phase_one_record_per_lane(app, rng):
    """With lanes every (batch, lane) pair is one pinned upload: 16 items at
    batch 8 over 8 lanes make 2 x 8 transfer records and as many compute
    records (a launch a lane)."""
    p = _scale(app, 3.0)
    prof = ProfileParameters(enable=True)
    p.stream(_mk(rng, 16), batch=8, sharded=True, lanes=True, sync=True, profile=prof)
    assert len(prof.phases["transfer"]) == len(prof.phases["compute"]) == 2 * 8
    assert prof.phase_total("transfer") > 0 and len(prof.samples) == 1


def test_lanes_joined_stream_row_aligned(app, rng):
    a = Scale(app).bind(infile="x", outfile="lhs", params=2.0)
    j = MulTwo(app).bind(infile="lhs", outfile="prod", rhs="r")
    pipe = Pipeline.from_graph(app, [a, j], output="prod")
    lhs, rhs = _mk(rng, 12), _mk(rng, 12)
    items = [{"x": l, "r": r} for l, r in zip(lhs, rhs)]
    want = [_host(l) * 2 * _host(r) for l, r in zip(lhs, rhs)]
    got = pipe.run(items, mode="stream", batch=8, sharded=True, lanes=True)
    _equal(got, want)
    assert pipe.build().executor.split_vectors == [(1,) * 8] * 2     # the tail of 4 pads
    _equal(pipe.run(items, mode="serve", batch=8, sharded=True, lanes=True), want, "served")


def test_single_device_traits_degrade_to_the_one_device_stream(rng):
    """One selected device: the mesh is trivial and sharded=True is the
    one-device stream; the proportional split and lanes run one lane."""
    app = _cpu_app(lanes=1)
    assert app.mesh.shape == {"data": 1, "model": 1}
    p = _scale(app, 4.0)
    data = _mk(rng, 4)
    _equal(p.stream(data, batch=2, sharded=True, sync=True), [_host(d) * 4.0 for d in data])
    assert p._lane_twins == {} and sorted(p._stream_twins) == [(2, 0), (2, 1)]
    _equal(p.stream(data, batch=2, sharded=True, lanes=True, sync=True),
           [_host(d) * 4.0 for d in data])
    assert p.split_vectors == [(2,), (2,)] and _lane_twins(p) == {0: 2}


# ---------------------------------------------------------------------------
# captures before the worker, replica apps, the 2D recon
# ---------------------------------------------------------------------------

def test_server_warmup_captures_every_lane_in_the_calling_thread(rec, app, rng, monkeypatch):
    """Launches compiled as on the card (the compiled-launch recorder):
    ``warmup()`` of a carved server captures each lane's twins (both upload
    slots, the full batch and the padded tail alike) in the calling
    thread; the worker only replays."""
    pipe = Pipeline(app) | Scale(app).bind(params=2.0)
    server = pipe.serve(batch=8, sharded=True, lanes=True, flush_timeout=0.02)
    captured_in = []
    capture = rec.__call__

    class Spy:
        def __call__(self, body, device):
            captured_in.append(threading.current_thread().name)
            return capture(body, device)
    monkeypatch.setattr(tprocess, "capture_graph", Spy())
    server.warmup(_mk(rng, 1)[0])
    twins = pipe.build().executor._lane_twins
    assert len(twins) == 16 and all(bp.captures == 1 for bp in twins.values())
    assert captured_in == [threading.current_thread().name] * 16
    try:
        data = _mk(rng, 11)
        rids = [server.submit(d) for d in data]
        by_rid = {r.rid: r.data for r in server.collect(len(rids), timeout=30.0)}
    finally:
        server.close()
    _equal([by_rid[r] for r in rids], [_host(d) * 2.0 for d in data])
    assert len(captured_in) == 16 and all(bp.captures == 1 for bp in twins.values())


def _mri(rng, n, frames=8):
    c, h, w = SMOKE.coils, SMOKE.height, SMOKE.width

    def cplx(shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    smaps = cplx((c, h, w))
    return [KData({"kdata": cplx((frames, c, h, w)), "sensitivity_maps": smaps.copy()})
            for _ in range(n)]


def test_split_replicas_each_launch(app, rng):
    """``CLapp.split(2)`` of the eight-lane app: two replicas of four lanes,
    each launching the recon on its own Data, equal to a one-lane app's."""
    data = _mri(rng, 2, frames=SMOKE.frames)
    one = _cpu_app(lanes=1)
    want = [(Pipeline(one) | SimpleMRIRecon(one, mode="fused_kernel")).run(d)
            .get_ndarray(0).host.copy() for d in data]
    reps = app.split(2)
    assert [r.mesh.shape["data"] for r in reps] == [4, 4]
    for r, d, w in zip(reps, data, want):
        got = (Pipeline(r) | SimpleMRIRecon(r, mode="fused_kernel")).run(d)
        np.testing.assert_array_equal(got.get_ndarray(0).host, w)


@pytest.mark.parametrize("mode", ["staged", "fused", "fused_kernel"])
def test_recon_2d_bit_identical_three_modes(rng, mode):
    """SimpleMRIRecon on a (data=2, model=4) mesh of CPU lanes: the frames
    (F=8) split 2 a piece over each model group, equal to the one-lane
    recon in launch, the sharded stream (equal and proportional), lanes and
    serve; bit for bit in the kernel mode, within 1e-6 with an FFT."""
    data = _mri(rng, 6)
    one = _cpu_app(lanes=1)
    want = [(Pipeline(one) | SimpleMRIRecon(one, mode=mode)).run(d).get_ndarray(0).host.copy()
            for d in data]
    app = _cpu_app(lanes=8, model=4)
    assert app.mesh.shape == {"data": 2, "model": 4}
    pipe = Pipeline(app) | SimpleMRIRecon(app, mode=mode)
    got = {"launch": [pipe.run(d).get_ndarray(0).host.copy() for d in data],
           "stream": pipe.run(data, mode="stream", batch=2, sharded=True),
           "proportional": pipe.run(data, mode="stream", batch=2, sharded=True,
                                    split="proportional"),
           "lanes": pipe.run(data, mode="stream", batch=4, sharded=True, lanes=True),
           "serve": pipe.run(data, mode="serve", batch=2, sharded=True)}
    for what, outs in got.items():
        for i, (g, w) in enumerate(zip(outs, want)):
            g = g if isinstance(g, np.ndarray) else _host(g)
            if mode == "fused_kernel":
                np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")
            else:
                np.testing.assert_allclose(g, w, **FFT_TOL, err_msg=f"{what}[{i}]")
    keys = {key[0] for key in pipe.build().executor.chain._lane_twins}
    assert keys == {(j, ("cpu",) * 4) for j in range(2)}


# ---------------------------------------------------------------------------
# against the JAX package on eight forced host devices
# ---------------------------------------------------------------------------

_JAX_CHILD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from repro.core import CLapp, DeviceTraits, KData, Pipeline
    from repro.core import stream as jstream
    from repro.launch.mesh import DeviceProfileRegistry
    from repro.processes import SimpleMRIRecon
    assert len(jax.devices()) == 8
    inp = np.load(sys.argv[1])
    mri = [KData({"kdata": k, "sensitivity_maps": inp["smaps"]}) for k in inp["kdata"]]
    app = CLapp().init(model_axis=4)
    pipe = Pipeline(app) | SimpleMRIRecon(app, mode="fused_pallas")
    recon = np.stack([pipe.run(d).get_ndarray(0).host.copy() for d in mri])
    # a proportional stream with set rates (ema 0: the measured launches
    # do not move them): record every split vector the plan decides
    vectors = []
    split_vector = jstream._BatchPlan.split_vector
    def recorded(self, rows):
        v = split_vector(self, rows)
        vectors.append(v)
        return v
    jstream._BatchPlan.split_vector = recorded
    app = CLapp().init()
    app.device_profiles = DeviceProfileRegistry(ema=0.0)
    for d, r in zip(app.devices, inp["rates"]):
        app.device_profiles.set_rate(d, float(r))
    slices = [KData({"kdata": k, "sensitivity_maps": s})
              for k, s in zip(inp["skdata"], inp["ssmaps"])]
    pipe = Pipeline(app) | SimpleMRIRecon(app, mode="fused")
    vectors.clear()
    outs = pipe.run(slices, mode="stream", batch=16, sharded=True, split="proportional",
                    tail_waste_threshold=0.0)
    stream = np.stack([o.get_ndarray(0).host for o in outs])
    np.savez(sys.argv[2], recon=recon, stream=stream, vectors=np.array(vectors))
""")


@pytest.fixture(scope="module")
def jax_eight(tmp_path_factory):
    """The JAX package's 2D recon (fused_pallas on a (2, 4) mesh of eight
    forced host devices) and a proportional stream with set rates, run
    once for this module in a subprocess; the inputs and the results."""
    rng = np.random.default_rng(11)
    c, h, w = SMOKE.coils, SMOKE.height, SMOKE.width

    def cplx(shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    inp = {"kdata": cplx((3, 8, c, h, w)), "smaps": cplx((c, h, w)),
           "skdata": cplx((21, SMOKE.frames, c, h, w)), "ssmaps": cplx((21, c, h, w)),
           "rates": np.array([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0])}
    tmp = tmp_path_factory.mktemp("jax_eight")
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_CHILD, str(tmp / "in.npz"),
                        str(tmp / "out.npz")], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    out = np.load(tmp / "out.npz")
    return inp, {k: out[k] for k in out.files}


def test_recon_2d_matches_the_jax_package_on_eight_devices(jax_eight):
    """The port's fused_kernel recon on a (data=2, model=4) mesh of CPU
    lanes equals its one-lane recon bit for bit and the JAX package's
    fused_pallas recon on eight forced host devices within 1e-4."""
    inp, out = jax_eight
    data = [KData({"kdata": k, "sensitivity_maps": inp["smaps"]}) for k in inp["kdata"]]
    one = _cpu_app(lanes=1)
    flat = [(Pipeline(one) | SimpleMRIRecon(one, mode="fused_kernel")).run(d)
            .get_ndarray(0).host.copy() for d in data]
    app = _cpu_app(lanes=8, model=4)
    pipe = Pipeline(app) | SimpleMRIRecon(app, mode="fused_kernel")
    got = [pipe.run(d).get_ndarray(0).host.copy() for d in data]
    for i, (g, f, j) in enumerate(zip(got, flat, out["recon"])):
        np.testing.assert_array_equal(g, f, err_msg=f"slice {i}")
        np.testing.assert_allclose(g, j, **JAX_TOL, err_msg=f"slice {i} vs JAX")


def test_proportional_split_vectors_match_the_jax_package(jax_eight):
    """The same set rates (one lane at 0) and 21 slices at batch 16 (an
    exact tail of 5): the port decides the JAX package's split vectors bit
    for bit, and its images agree with the JAX stream's within 1e-4."""
    inp, out = jax_eight
    app = _cpu_app()
    app.device_profiles = DeviceProfileRegistry(ema=0.0)
    for j, r in enumerate(inp["rates"]):
        app.device_profiles.set_rate(j, float(r))
    slices = [KData({"kdata": k, "sensitivity_maps": s})
              for k, s in zip(inp["skdata"], inp["ssmaps"])]
    pipe = Pipeline(app) | SimpleMRIRecon(app, mode="fused")
    outs = pipe.run(slices, mode="stream", batch=16, sharded=True, split="proportional",
                    tail_waste_threshold=0.0)
    vectors = pipe.build().executor.chain.split_vectors
    assert [tuple(int(c) for c in v) for v in out["vectors"]][-len(vectors):] == vectors
    assert [sum(v) for v in vectors] == [16, 5] and vectors[0][0] == vectors[1][0] == 0
    for i, (o, j) in enumerate(zip(outs, out["stream"])):
        np.testing.assert_allclose(_host(o), j, **JAX_TOL, err_msg=f"slice {i}")
