"""The port's mesh layer (``repro_torch.launch.mesh``) on the CPU: ``Mesh``,
``make_data_mesh`` and its kin, the logical-axis table and
``shard_by_logical`` (its no-op rules, and the frame split over a model
group of CPU lanes), the placements ``host2device`` and ``StreamQueue``
take, ``CLapp``'s mesh, ``set_mesh`` and ``split``, and the per-lane
throughput profiles held against the JAX package's ``repro.launch.mesh``
on the same inputs: a counterpart of each test of
``tests/test_proportional.py``'s registry part (the same rates and rows
give the same split vectors, fallbacks and zero-rate cases included).
"""
import math

import numpy as np
import pytest
import torch

from repro.launch import mesh as jmesh
from repro_torch.core import (CLapp, DeviceTraits, DeviceType, NoMatchingDeviceError,
                              StreamQueue, XData)
from repro_torch.core.arena import carve_rows
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import (LOGICAL_AXES, DeviceProfile, DeviceProfileRegistry, Mesh,
                                     logical_pspec, make_data_mesh, mesh_axis,
                                     model_axis_size, shard_by_logical)

CPU = torch.device("cpu")


@pytest.fixture
def app():
    return CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))


class _Dev:
    """The JAX registry's stand-in device: it reads only ``.id``."""

    def __init__(self, id):
        self.id = id


def _both(n):
    """A fresh JAX registry and port registry, with n devices / lanes."""
    return (jmesh.DeviceProfileRegistry(), [_Dev(i) for i in range(n)],
            DeviceProfileRegistry(), list(range(n)))


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_mesh_grid_shape_groups_and_equality():
    m = make_data_mesh([CPU] * 8)
    assert m.shape == {"data": 8, "model": 1}
    assert m.groups == ((CPU,),) * 8 and m.device_list == [CPU] * 8
    m2 = make_data_mesh([CPU] * 8, model=4)
    assert m2.shape == {"data": 2, "model": 4}
    assert m2.devices.shape == (2, 4) and m2.groups == ((CPU,) * 4,) * 2
    assert model_axis_size(m2) == 4 and model_axis_size(m) == 1 and model_axis_size(None) == 1
    assert m == make_data_mesh(["cpu"] * 8) and m != m2 and hash(m) == hash(make_data_mesh([CPU] * 8))
    one = tmesh.make_device_mesh(CPU)
    assert one == tmesh.make_group_mesh([CPU]) == tmesh.make_host_mesh()
    assert tmesh.make_group_mesh([CPU] * 3).shape == {"data": 1, "model": 3}
    with pytest.raises(ValueError, match="divide"):
        make_data_mesh([CPU] * 8, model=3)
    with pytest.raises(ValueError, match="zero devices"):
        make_data_mesh([])
    with pytest.raises(ValueError, match=">= 1"):
        make_data_mesh([CPU], model=0)
    with pytest.raises(ValueError, match="zero devices"):
        tmesh.make_group_mesh([])
    with pytest.raises(ValueError, match="same number"):
        Mesh([[CPU, CPU], [CPU]])
    with pytest.raises(RuntimeError, match="needs 512 CUDA devices; 0 found"):
        tmesh.make_production_mesh(multi_pod=True)


def test_production_mesh_over_the_visible_cards(monkeypatch):
    """The reference's (data 16, model 16) and (pod 2, data 16, model 16)
    meshes over the first 256 / 512 cards, when that many are visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 300)
    single = tmesh.make_production_mesh()
    assert single.shape == {"data": 16, "model": 16} and len(single.groups) == 16
    assert single.device_list == [torch.device("cuda", i) for i in range(256)]
    with pytest.raises(RuntimeError, match="needs 512 CUDA devices; 300 found"):
        tmesh.make_production_mesh(multi_pod=True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 512)
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.devices.shape == (2, 16, 16) and len(multi.groups) == 32
    assert multi.groups[17] == tuple(torch.device("cuda", 17 * 16 + i) for i in range(16))
    assert model_axis_size(multi) == 16
    with pytest.raises(ValueError, match="two axes"):
        Mesh([[CPU]], ("data",))


def test_logical_axis_table_contract():
    """The port's table is the JAX package's, name for name, and resolves
    as its ``logical_pspec`` does (a tuple for a PartitionSpec)."""
    assert LOGICAL_AXES == jmesh.LOGICAL_AXES
    assert LOGICAL_AXES["batch"] == "data"
    assert LOGICAL_AXES["frame"] == LOGICAL_AXES["slot"] == "model"
    assert logical_pspec(("frame", "coil", None)) == ("model", None, None) \
        == tuple(jmesh.logical_pspec(("frame", "coil", None)))
    assert logical_pspec(None) == ()
    with pytest.raises(KeyError, match="logical axis"):
        mesh_axis("no_such_axis")
    assert tmesh.logical_sharding(make_data_mesh([CPU] * 2), ("batch",)).spec == ("data",)


def test_shard_by_logical_no_op_rules():
    """No mesh, a trivial model axis, or an indivisible frame axis: the
    function runs once, on the whole arguments (as the JAX wrapper's total
    no-op); a model group of 4 CPU lanes splits frames into 4 calls."""
    calls = []

    def fn(x, s):
        calls.append(tuple(x.shape))
        return x * s.sum()

    f = shard_by_logical(fn, [("frame", None), None], ("frame", None))
    x, s = torch.arange(8.0).reshape(4, 2), torch.ones(3)
    want = x * 3.0
    torch.testing.assert_close(f(x, s), want)                    # no mesh anywhere
    m1 = make_data_mesh([CPU] * 8)                               # model axis trivial
    torch.testing.assert_close(shard_by_logical(fn, [("frame", None), None],
                                                ("frame", None), mesh=m1)(x, s), want)
    m3 = make_data_mesh([CPU] * 6, model=3)                      # 4 frames over 3: whole
    torch.testing.assert_close(shard_by_logical(fn, [("frame", None), None],
                                                ("frame", None), mesh=m3)(x, s), want)
    assert calls == [(4, 2)] * 3
    m4 = make_data_mesh([CPU] * 8, model=4)
    out = torch.empty(4, 2)
    got = shard_by_logical(fn, [("frame", None), None], ("frame", None), mesh=m4)(x, s, out=out)
    assert got is out and calls[3:] == [(1, 2)] * 4
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="in_axes"):
        shard_by_logical(fn, [("frame", None)], ("frame", None), mesh=m4)(x, s)
    # a list of out annotations: one per output, an output with no model dim
    # taken from the first piece
    g = shard_by_logical(lambda a: (a + 1, a.new_ones(2)), [("frame", None)],
                         [("frame", None), (None,)], mesh=m4)
    a, b = g(x)
    torch.testing.assert_close(a, x + 1)
    torch.testing.assert_close(b, torch.ones(2))


def test_shard_by_logical_resolves_the_launch_mesh(app):
    """``mesh=None`` reads the mesh of the launch in progress: a launch on
    an app whose mesh has a model group of 4 splits the frames in 4."""
    from repro_torch.core import Process

    seen = []

    class Frames(Process):
        batch_axis = True

        def apply(self, views, aux, params, out=None):
            def body(v):
                seen.append(v.shape[0])
                return v * 2
            return {k: shard_by_logical(body, [("frame", None)], ("frame", None))(v)
                    for k, v in views.items()}

    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    d_in, d_out = XData({"img": x}), XData({"img": np.zeros_like(x)})
    p = Frames(app)
    p.in_handle, p.out_handle = app.addData(d_in), app.addData(d_out)
    p.launch()
    app.set_mesh(make_data_mesh([CPU] * 8, model=4))
    p.launch()
    app.device2Host(p.out_handle)
    np.testing.assert_array_equal(d_out.get_ndarray(0).host, 2 * x)
    assert seen == [8, 2, 2, 2, 2]
    from repro_torch.core.process import current_compile_mesh
    assert current_compile_mesh() is None                     # only during a launch


# ---------------------------------------------------------------------------
# placements, CLapp's mesh, set_mesh, split
# ---------------------------------------------------------------------------

def test_placements_reach_host2device_and_the_queue(app):
    assert app.mesh == make_data_mesh([CPU])
    assert app.default_sharding == tmesh.pinned_sharding(CPU)
    assert app.data_sharding(("data",)).spec == ("data",)
    assert app.data_sharding().device_set == {CPU}
    grp = tmesh.group_sharding([CPU, CPU])
    assert grp.mesh.shape == {"data": 1, "model": 2} and grp.device == CPU
    d = XData({"img": np.ones((4, 4), np.float32)})
    h = app.addData(d, to_device=False)
    app.host2device(h, sharding=tmesh.pinned_sharding(CPU))
    np.testing.assert_array_equal(d.device_view("img").numpy(), np.ones((4, 4)))
    q = StreamQueue(iter([np.full(5, i, np.uint8) for i in range(3)]),
                    device=tmesh.pinned_sharding(CPU))
    assert q.device == CPU and [int(b[0]) for b in q] == [0, 1, 2]


def test_init_builds_the_mesh_and_set_mesh_keeps_it(app):
    mesh = make_data_mesh([CPU] * 8)
    app.set_mesh(mesh)
    app.init(device_traits=DeviceTraits(type=DeviceType.CPU))
    assert app.mesh is mesh                                  # an explicit mesh survives
    app.set_mesh(None)
    app.init(device_traits=DeviceTraits(type=DeviceType.CPU))
    assert app.mesh == make_data_mesh([CPU])
    with pytest.raises(ValueError, match="divide"):
        CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU), model_axis=2)


def test_a_mesh_naming_an_absent_card_raises(app, monkeypatch):
    """A mesh that names a CUDA device with no CUDA present raises: nothing
    runs on the CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoMatchingDeviceError, match="cuda:1"):
        app.set_mesh(make_data_mesh([CPU, torch.device("cuda", 1)]))
    assert app.mesh == make_data_mesh([CPU])


def test_split_into_replica_apps(app):
    """``split(n)``: disjoint contiguous replicas, each its own mesh, data
    registry and profile registry; extra devices to the earlier ones."""
    with pytest.raises(ValueError, match="at least one device"):
        app.split(2)
    app.set_mesh(make_data_mesh([CPU] * 5))
    app.device_profiles.set_rate(0, 5.0)
    reps = app.split(2)
    assert [len(r.devices) for r in reps] == [3, 2]
    assert [r.mesh.shape for r in reps] == [{"data": 3, "model": 1}, {"data": 2, "model": 1}]
    assert all(r.device_profiles is not app.device_profiles for r in reps)
    assert reps[0].device_profiles.profile(0).cold
    h = reps[0].addData(XData({"img": np.ones(3, np.float32)}))
    assert h not in reps[1]._data and reps[0].kernels is not reps[1].kernels
    with pytest.raises(ValueError, match="n >= 1"):
        app.split(0)
    with pytest.raises(RuntimeError, match="init"):
        CLapp().split(1)


def test_carve_rows_is_views_in_order():
    stacked = np.arange(12, dtype=np.uint8).reshape(6, 2)
    parts = carve_rows(stacked, (1, 0, 3, 2))
    assert [p.shape[0] for p in parts] == [1, 0, 3, 2]
    assert all(np.shares_memory(p, stacked) for p in parts if len(p))
    np.testing.assert_array_equal(np.concatenate(parts), stacked)
    t = torch.arange(6)
    assert [x.tolist() for x in carve_rows(t, (2, 4))] == [[0, 1], [2, 3, 4, 5]]
    assert carve_rows(list("abc"), (2, 1)) == [["a", "b"], ["c"]]
    with pytest.raises(ValueError, match="covers"):
        carve_rows(stacked, (1, 2))


# ---------------------------------------------------------------------------
# DeviceProfile / DeviceProfileRegistry against repro.launch.mesh
# ---------------------------------------------------------------------------

def test_device_profile_records_ema():
    for p in (DeviceProfile(lane=0, ema=0.5), jmesh.DeviceProfile(device_id=0, ema=0.5)):
        assert p.cold and p.rate != p.rate
        p.record(10, 1.0)
        assert p.rate == pytest.approx(10.0)
        p.record(20, 1.0)
        assert p.rate == pytest.approx(15.0) and p.items == 30
        assert len(p.seconds.samples) == 2 and p.seconds.mean() == pytest.approx(1.0)


def test_device_profile_ignores_degenerate_samples_and_set_rate():
    for p in (DeviceProfile(lane=0), jmesh.DeviceProfile(device_id=0)):
        p.record(0, 1.0)
        p.record(4, 0.0)
        p.record(4, -1.0)
        assert p.cold
        p.set_rate(3.0)
        assert p.rate == 3.0 and not p.cold
        with pytest.raises(ValueError):
            p.set_rate(-1.0)


def test_registry_record_rates_warm_total_reset():
    jreg, devs, treg, lanes = _both(2)
    for reg, ks in ((jreg, devs), (treg, lanes)):
        reg.record(ks[0], 8, 2.0)
        r = reg.rates(ks)
        assert r[0] == pytest.approx(4.0) and r[1] != r[1]
        assert not reg.warm(ks) and math.isnan(reg.total_rate(ks))
        reg.set_rate(ks[1], 1.0)
        assert reg.warm(ks) and reg.total_rate(ks) == pytest.approx(5.0)
        reg.reset()
        assert not reg.warm(ks[:1])


@pytest.mark.parametrize("rates,rows", [
    ((1.0, 2.0, 5.0), 16),                  # exact proportions
    ((1.0, 1.0, 1.0), 7),                   # ties -> the earlier lane
    ((2.0, 2.0, 2.0, float("nan")), 16),    # one cold lane -> None
    ((2.0, 2.0, 2.0, 2.0), 7),              # rows < 2 n -> None
    ((2.0, 2.0, 2.0, 2.0), 8),
    ((0.0, 1.0, 3.0), 16),                  # a zero-rate lane gets nothing
    ((0.0, 0.0), 8),                        # all zero -> None
    ((1.0, 7.0, 7.0, 7.0, 7.0, 7.0, 7.0, 7.0), 50),
])
def test_split_vectors_equal_the_jax_registry(rates, rows):
    jreg, devs, treg, lanes = _both(len(rates))
    for d, j, r in zip(devs, lanes, rates):
        if r == r:
            jreg.set_rate(d, r)
            treg.set_rate(j, r)
    assert treg.split(rows, lanes) == jreg.split(rows, devs)


def test_split_vectors_equal_the_jax_registry_on_random_rates():
    """400 seeded draws of 1-8 lanes, 1-64 rows and rates (zeros, cold
    lanes, measured EMAs): the port's vector is the JAX registry's."""
    rng = np.random.default_rng(7)
    for _ in range(400):
        n = int(rng.integers(1, 9))
        jreg, devs, treg, lanes = _both(n)
        for d, j in zip(devs, lanes):
            kind = rng.random()
            if kind < 0.1:
                continue                                   # cold
            if kind < 0.2:
                jreg.set_rate(d, 0.0)
                treg.set_rate(j, 0.0)
                continue
            for _ in range(int(rng.integers(1, 4))):       # measured launches
                items, secs = int(rng.integers(1, 9)), float(rng.uniform(1e-4, 1e-2))
                jreg.record(d, items, secs)
                treg.record(j, items, secs)
        rows = int(rng.integers(1, 65))
        assert treg.split(rows, lanes) == jreg.split(rows, devs)
        assert treg.rates(lanes) == pytest.approx(jreg.rates(devs), nan_ok=True)


def test_split_zero_lanes_raises_and_balanced_vector():
    with pytest.raises(ValueError):
        DeviceProfileRegistry().split(8, [])
    with pytest.raises(ValueError):
        DeviceProfileRegistry.balanced(8, 0)
    for rows, n in ((10, 4), (8, 4), (2, 4), (0, 3), (13, 8)):
        assert DeviceProfileRegistry.balanced(rows, n) == \
            jmesh.DeviceProfileRegistry.balanced(rows, n)
    assert DeviceProfileRegistry.balanced(10, 4) == (3, 3, 2, 2)
