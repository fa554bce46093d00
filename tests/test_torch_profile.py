"""Profiling parity: the port's ``ProfileParameters`` and the phases its
launches, staged chains, Pipelines, streams and ``LMServer`` record,
against the JAX package's on the CPU.

* The statistics (``mean``, ``p50``, ``p99``, ``percentile``,
  ``phase_totals``) of the same samples are equal exactly: both packages
  do the same numpy arithmetic; with no samples, or a disabled profile,
  they are ``nan``.
* The phase names and their counts are equal for the same inputs (made
  from a numpy seed): ``Negate`` launches, a staged and a fused
  ``ProcessChain``, ``SimpleMRIRecon`` at SMOKE size in its three modes,
  the three-stage ``Pipeline.run`` of ``tests/test_residency.py``,
  ``Process.stream`` with host and device-resident items and a ragged
  tail, and ``LMServer`` at SMOKE size (qwen3-14b, rwkv6-3b).  The JAX
  package counts a ``"compile"`` per compile-cache miss of its global
  cache, so the stream cases start it empty.  The outputs keep matching:
  rtol 1e-5 for a launch, 1e-4 for a streamed batch.
* Through the compiled launch's recorder (``test_torch_compiled_launch.
  py``'s ``rec``): a replayed staged chain still records one
  ``"compute"`` per stage; a stream twin's capture lands in its row
  count's one ``"compile"``, and no replay records one; and
  ``compile_cache_stats()`` (a hit is a graph replay, a miss a capture)
  moves as the JAX package's does in ``tests/test_pipeline.py``'s cases,
  where the port compiles on a launch's second run.
"""
import threading

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import processes as jproc
from repro.core import process as jprocess
from repro.serve import LMServer as JServer, SamplingConfig as JSampling
import repro_torch.core as tcore
from repro_torch.configs.mri_recon import SMOKE
from repro_torch.core import (CLapp, DeviceTraits, DeviceType, Pipeline, PortError, Process,
                              ProcessChain, ProfileParameters, XData, compile_cache_stats)
from repro_torch.core.process import _PhaseView
from repro_torch.processes import CombineParams, Negate, SimpleMRIRecon, XImageSum
from repro_torch.serve import LMServer, SamplingConfig
from test_torch_compiled_launch import rec  # noqa: F401  (the recorder fixture)
from test_torch_lm import MAX_LEN, _cpu_app, _jax, _port

SHAPE = (SMOKE.frames, SMOKE.coils, SMOKE.height, SMOKE.width)
LAUNCH_TOL = dict(rtol=1e-5, atol=1e-5)
BATCH_TOL = dict(rtol=1e-4, atol=1e-4)
JMODE = {"staged": "staged", "fused": "fused", "fused_kernel": "fused_pallas"}


class TAddConst(Process):
    batch_axis = True

    def apply(self, views, aux, params, out=None):
        return {k: v + params for k, v in views.items()}


class TScale(Process):
    batch_axis = True

    def apply(self, views, aux, params, out=None):
        return {k: v * params for k, v in views.items()}


class JAddConst(jcore.Process):
    def apply(self, views, aux, params):
        return {k: v + params for k, v in views.items()}


class JScale(jcore.Process):
    def apply(self, views, aux, params):
        return {k: v * params for k, v in views.items()}


@pytest.fixture
def app():
    return CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))


@pytest.fixture
def fresh_jax_cache():
    """The JAX package's compile cache empty for the test, then restored:
    its ``"compile"`` phase counts this cache's misses."""
    saved = dict(jprocess._COMPILE_CACHE)
    jprocess._COMPILE_CACHE.clear()
    yield
    jprocess._COMPILE_CACHE.clear()
    jprocess._COMPILE_CACHE.update(saved)


def _host(app, h) -> np.ndarray:
    """The first array of Data ``h`` copied to the host (either package)."""
    d = app.getData(h)
    d.sync_to_host()
    return np.asarray(d.get_ndarray(0).host)


def _counts(prof) -> dict:
    return {k: len(v) for k, v in prof.phases.items()}


def _profiles():
    return ProfileParameters(enable=True), jcore.ProfileParameters(enable=True)


def _settle_jax_transfer_timers():
    """The JAX package records each streamed upload's ``"transfer"`` phase
    from a daemon thread (``transfer-timer``) that wakes when the upload
    lands, and its stream returns without waiting for them: on a loaded
    host the profile can still miss some.  Wait for them all."""
    for t in threading.enumerate():
        if t.name == "transfer-timer":
            t.join()


def _same_phases(tprof, jprof, samples=True):
    _settle_jax_transfer_timers()
    assert _counts(tprof) == _counts(jprof)
    assert all(s >= 0 for v in tprof.phases.values() for s in v)
    if samples:
        assert len(tprof.samples) == len(jprof.samples)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("samples", [[1.0, 2.0, 3.0, 10.0], [0.5], [3.0, 1.0, 2.0],
                                     list(np.random.default_rng(5).exponential(1e-3, 101))])
def test_statistics_equal_the_jax_packages(samples):
    tprof, jprof = _profiles()
    for s in samples:
        tprof.record(s)
        jprof.record(s)
    for i, s in enumerate(samples):
        for prof in (tprof, jprof):
            prof.record_phase("compute", s)
            prof.record_phase("transfer" if i % 2 else "compile", 2 * s)
    assert tprof.mean() == jprof.mean()
    assert tprof.p50() == jprof.p50() and tprof.p99() == jprof.p99()
    for q in (0, 10, 50, 90, 99, 100):
        assert tprof.percentile(q) == jprof.percentile(q)
    assert tprof.phase_totals() == jprof.phase_totals()
    assert tprof.phase_total("absent") == jprof.phase_total("absent") == 0.0


def test_statistics_with_no_samples_are_nan():
    """The reference's ``test_profile_parameters_zero_samples_is_nan`` and
    ``test_profile_parameters_statistics``, ported."""
    prof = ProfileParameters(enable=True)
    assert np.isnan(prof.mean()) and np.isnan(prof.percentile(50))
    assert np.isnan(prof.p50()) and np.isnan(prof.p99())
    assert prof.phase_totals() == {}
    for s in (1.0, 2.0, 3.0, 10.0):
        prof.record(s)
    assert prof.mean() == 4.0 and prof.p50() == 2.5 and prof.p99() <= 10.0
    disabled = ProfileParameters(enable=False)
    disabled.record(5.0)
    disabled.record_phase("compute", 5.0)
    assert np.isnan(disabled.mean()) and disabled.phases == {}
    view = _PhaseView(prof)
    view.record(7.0)
    view.record_phase("compute", 7.0)
    assert len(prof.samples) == 4 and prof.phases == {"compute": [7.0]}
    assert not _PhaseView(disabled).enable


# ---------------------------------------------------------------------------
# launches, chains, SimpleMRIRecon and Pipeline.run against the JAX package
# ---------------------------------------------------------------------------

def _img(rng, shape=(6, 5)):
    return rng.standard_normal(shape).astype(np.float32)


def _wire_chain(mod, app, x, mode):
    """x -> AddConst(1.5) -> Scale(-2) -> out, the input not yet uploaded."""
    add, scale = (TAddConst, TScale) if mod is tcore else (JAddConst, JScale)
    h_in = app.addData(mod.XData({"img": x}), to_device=False)
    h_mid = app.addData(mod.XData({"img": np.zeros_like(x)}))
    h_out = app.addData(mod.XData({"img": np.zeros_like(x)}))
    p1, p2 = add(app), scale(app)
    p1.in_handle, p1.out_handle = h_in, h_mid
    p1.set_launch_parameters(1.5)
    p2.in_handle, p2.out_handle = h_mid, h_out
    p2.set_launch_parameters(-2.0)
    chain = (ProcessChain if mod is tcore else jcore.ProcessChain)(app, [p1, p2], mode=mode)
    chain.init()
    return chain, h_out


def _launch_three(proc, prof):
    for _ in range(3):
        proc.launch(prof)


@pytest.mark.parametrize("kind", ["negate", "chain_staged", "chain_fused"])
def test_launch_phases_match_jax(app, kind):
    """The first launch uploads its input (``"transfer"``), every launch
    records ``"compute"``: once, or once a stage for a staged chain."""
    x = _img(np.random.default_rng(11))
    japp = jcore.CLapp().init()
    tprof, jprof = _profiles()
    procs = []
    for mod, a, cls in ((tcore, app, Negate), (jcore, japp, jproc.Negate)):
        if kind == "negate":
            p = cls(a)
            p.in_handle = a.addData(mod.XData({"img": x}), to_device=False)
            p.out_handle = h_out = a.addData(mod.XData({"img": np.zeros_like(x)}))
            p.init()
        else:
            p, h_out = _wire_chain(mod, a, x, kind.removeprefix("chain_"))
        procs.append((p, h_out))
    want = 1.0 - x if kind == "negate" else (x + 1.5) * -2.0
    (tp, t_out), (jp, j_out) = procs
    _launch_three(tp, tprof)
    _launch_three(jp, jprof)
    _same_phases(tprof, jprof)
    expect = {"compute": 6 if kind == "chain_staged" else 3, "transfer": 1}
    if kind == "chain_staged":
        expect["transfer"] = 1            # the first stage's input, on the first launch
    assert _counts(tprof) == expect
    got = _host(app, t_out)
    np.testing.assert_allclose(got, want, **LAUNCH_TOL)
    np.testing.assert_allclose(got, _host(japp, j_out), **LAUNCH_TOL)


def _kdata(mod, rng):
    f, c, h, w = SHAPE
    k = (rng.standard_normal((f, c, h, w)) + 1j * rng.standard_normal((f, c, h, w))
         ).astype(np.complex64)
    s = (rng.standard_normal((c, h, w)) + 1j * rng.standard_normal((c, h, w))
         ).astype(np.complex64)
    return mod.KData({"kdata": k, "sensitivity_maps": s})


def _recon(mod, app, cls, d, mode, to_device=False):
    f, _, h, w = SHAPE
    p = cls(app, mode=mode, in_place=False)
    p.in_handle = app.addData(d, to_device=to_device)
    p.out_handle = app.addData(mod.XData({"xdata": np.zeros((f, h, w), np.complex64)}))
    p.init()
    return p


@pytest.mark.parametrize("mode", ["staged", "fused", "fused_kernel"])
def test_simple_mri_recon_phases_match_jax(app, mode):
    """Three profiled launches at SMOKE size, the k-space uploaded by the
    first: staged records three ``"compute"`` a launch, fused and
    fused_kernel one."""
    japp = jcore.CLapp().init()
    tprof, jprof = _profiles()
    tp = _recon(tcore, app, SimpleMRIRecon, _kdata(tcore, np.random.default_rng(2)), mode)
    jp = _recon(jcore, japp, jproc.SimpleMRIRecon, _kdata(jcore, np.random.default_rng(2)),
                JMODE[mode])
    _launch_three(tp, tprof)
    _launch_three(jp, jprof)
    _same_phases(tprof, jprof)
    assert _counts(tprof) == {"transfer": 1, "compute": 9 if mode == "staged" else 3}
    np.testing.assert_allclose(_host(app, tp.out_handle), _host(japp, jp.out_handle),
                               **LAUNCH_TOL)


def test_three_stage_pipeline_run_phases_match_jax(app):
    """``tests/test_residency.py``'s profiled three-stage pipeline: one
    ``"transfer"`` a run (the graph input), one ``"compute"`` a stage."""
    rng = np.random.default_rng(4)
    xs = [_img(rng, (8, 8)) for _ in range(3)]
    japp = jcore.CLapp().init()
    pipes = []
    for a, add, scale, pipe in ((app, TAddConst, TScale, Pipeline),
                                (japp, JAddConst, JScale, jcore.Pipeline)):
        pipes.append(pipe(a)
                     | add(a).bind(infile="src", outfile="mid1", params=1.5)
                     | scale(a).bind(infile="mid1", outfile="mid2", params=-2.0)
                     | add(a).bind(infile="mid2", outfile="final", params=0.25))
    tprof, jprof = _profiles()
    for x in xs:
        got = pipes[0].run(XData({"img": x}), profile=tprof).get_ndarray(0).host
        want = pipes[1].run(jcore.XData({"img": x}), profile=jprof).get_ndarray(0).host
        np.testing.assert_allclose(got, (x + 1.5) * -2.0 + 0.25, **LAUNCH_TOL)
        np.testing.assert_allclose(got, want, **LAUNCH_TOL)
    _same_phases(tprof, jprof)
    assert _counts(tprof) == {"transfer": 3, "compute": 9}
    assert tprof.phase_total("transfer") > 0


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def _stream_pair(app, japp, shape):
    procs = []
    for mod, a, cls in ((tcore, app, TAddConst), (jcore, japp, JAddConst)):
        d_in = mod.XData({"img": np.zeros(shape, np.float32)})
        p = cls(a)
        p.in_handle = a.addData(d_in)
        p.out_handle = a.addData(mod.XData(d_in, copy_values=False))
        p.set_launch_parameters(0.5)
        p.init()
        procs.append(p)
    return procs


@pytest.mark.parametrize("n,batch", [(7, 3), (8, 3), (6, 2)])
def test_stream_phases_match_jax(app, fresh_jax_cache, n, batch):
    """Host items, then the results (device-resident) streamed through the
    same process: ``"transfer"`` / ``"transfer_d2d"`` a batch, ``"compute"``
    a launch (the tail's too), ``"compile"`` a new row count: a tail twin
    (7 at 3, waste 2/3) is one more, a padded tail (8 at 3) none, and the
    second stream, on the twins the first set up, none."""
    shape = (3, 4 + n)                     # one shape a case: the JAX cache starts empty
    japp = jcore.CLapp().init()
    tp, jp = _stream_pair(app, japp, shape)
    rng = np.random.default_rng(n)
    xs = [_img(rng, shape) for _ in range(n)]
    tprof, jprof = _profiles()
    tout = tp.stream([XData({"img": x}) for x in xs], batch=batch, profile=tprof)
    jout = jp.stream([jcore.XData({"img": x}) for x in xs], batch=batch, profile=jprof)
    _same_phases(tprof, jprof)
    batches = -(-n // batch)
    tail_twin = n % batch and (batch - n % batch) / batch > 0.5
    assert _counts(tprof) == {"compile": 2 if tail_twin else 1, "transfer": batches,
                              "compute": batches}
    for x, t, j in zip(xs, tout, jout):
        np.testing.assert_allclose(t.device_view("img").numpy(), x + 0.5, **BATCH_TOL)
        np.testing.assert_allclose(t.device_view("img").numpy(),
                                   np.asarray(j.device_view("img")), **BATCH_TOL)
    tprof2, jprof2 = _profiles()
    tout2 = tp.stream(tout, batch=batch, profile=tprof2)
    jp.stream(jout, batch=batch, profile=jprof2)
    _same_phases(tprof2, jprof2)
    assert _counts(tprof2) == {"transfer_d2d": batches, "compute": batches}
    for x, t in zip(xs, tout2):
        np.testing.assert_allclose(t.device_view("img").numpy(), x + 1.0, **BATCH_TOL)


# ---------------------------------------------------------------------------
# LMServer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-3b"])
def test_lmserver_phases_match_jax(arch):
    """5 prompts through 2 slots: the prefill profile holds a
    ``"transfer"`` a prompt (and one of the zero state, which the port
    makes with the server and the JAX package's first splice uploads) and
    a ``"compute"`` a prefill and a splice, the
    decode profile a ``"compute"`` a step and a release, as the JAX
    LMServer's; the port's samples stay one a prefill and one a step."""
    jmodel, jparams = _jax(arch)
    model, weights = _port(arch)
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(0, model.cfg.vocab, n)) for n in (3, 9, 5, 9, 4)]
    jsrv = JServer(jmodel, jparams, batch=2, max_len=MAX_LEN,
                   sampling=JSampling(max_new_tokens=4))
    tsrv = LMServer(model, weights, batch=2, max_len=MAX_LEN,
                    sampling=SamplingConfig(max_new_tokens=4), app=_cpu_app())
    for p in prompts:
        jsrv.submit(p)
        tsrv.submit(p)
    assert tsrv.run() == jsrv.run()
    _same_phases(tsrv.prefill_profile, jsrv.prefill_profile, samples=False)
    _same_phases(tsrv.decode_profile, jsrv.decode_profile, samples=False)
    n = len(prompts)
    # a prompt's upload each, and the zero state's
    assert _counts(tsrv.prefill_profile) == {"transfer": n + 1, "compute": 2 * n}
    assert _counts(tsrv.decode_profile) == {"compute": tsrv.steps + n}
    assert len(tsrv.prefill_profile.samples) == n
    assert len(tsrv.decode_profile.samples) == tsrv.steps


# ---------------------------------------------------------------------------
# the compiled launch, through the recorder
# ---------------------------------------------------------------------------

def test_replayed_staged_chain_records_a_compute_a_stage(rec, app):
    """Eager, captured, then replayed: every launch of a two-stage chain
    records two ``"compute"``, each stage's events recorded by the graph; a
    profiled launch after unprofiled ones captures its own graph, so it
    never reads events that the unprofiled graph did not record."""
    x = _img(np.random.default_rng(1))
    h_in = app.addData(XData({"img": x}))
    h_mid, h_out = (app.addData(XData({"img": np.zeros_like(x)})) for _ in range(2))
    a, b = Negate(app), Negate(app)
    a.in_handle, a.out_handle = h_in, h_mid
    b.in_handle, b.out_handle = h_mid, h_out
    chain = ProcessChain(app, [a, b], mode="staged")
    chain.init()
    for _ in range(3):
        chain.launch()
    assert (chain.captures, chain.replays) == (1, 2)
    prof = ProfileParameters(enable=True)
    for _ in range(4):
        chain.launch(prof)
    assert (chain.captures, chain.replays) == (2, 6)
    assert rec.events.count("capture") == 2
    assert _counts(prof) == {"compute": 8} and len(prof.samples) == 4
    assert all(s >= 0 for s in prof.phases["compute"])
    np.testing.assert_allclose(_host(app, h_out), x, **LAUNCH_TOL)


@pytest.mark.parametrize("mode", ["staged", "fused", "fused_kernel"])
def test_replayed_simple_mri_recon_phases(rec, app, mode):
    """Five profiled launches (eager, capture, replays) of SimpleMRIRecon
    at SMOKE size, the k-space on the device: the same counts as eager."""
    p = _recon(tcore, app, SimpleMRIRecon, _kdata(tcore, np.random.default_rng(3)), mode,
               to_device=True)
    prof = ProfileParameters(enable=True)
    for _ in range(5):
        p.launch(prof)
    assert (p.chain.captures, p.chain.replays) == (1, 4)
    assert _counts(prof) == {"compute": 15 if mode == "staged" else 5}


def test_captured_stream_twin_records_its_compile_once(rec, app):
    """6 items at batch 2 over 2 upload slots: slot 0's twin launches twice
    and captures in the first stream, whose one ``"compile"`` (row count 2)
    holds the twins' set-up and that capture; the second stream captures
    slot 1's twin and replays, and records no ``"compile"``."""
    d_in = XData({"img": np.zeros((4, 4), np.float32)})
    p = TAddConst(app)
    p.in_handle, p.out_handle = app.addData(d_in), app.addData(XData(d_in, copy_values=False))
    p.set_launch_parameters(1.0)
    p.init()
    xs = [_img(np.random.default_rng(i), (4, 4)) for i in range(6)]
    prof = ProfileParameters(enable=True)
    out = p.stream([XData({"img": x}) for x in xs], batch=2, profile=prof)
    twins = p._stream_twins
    assert (twins[(2, 0)].captures, twins[(2, 1)].captures) == (1, 0)
    assert _counts(prof) == {"compile": 1, "transfer": 3, "compute": 3}
    assert prof.phases["compile"][0] >= twins[(2, 0)].twin.capture_seconds > 0
    for x, o in zip(xs, out):
        np.testing.assert_array_equal(o.device_view("img").numpy(), x + 1.0)
    prof2 = ProfileParameters(enable=True)
    p.stream([XData({"img": x}) for x in xs], batch=2, profile=prof2)
    assert twins[(2, 1)].captures == 1 and twins[(2, 0)].replays == 3
    assert _counts(prof2) == {"transfer": 3, "compute": 3}


def test_compile_cache_stats_validation_compiles_nothing(rec, app):
    """``tests/test_pipeline.py``'s mis-wired build: no capture, no replay."""
    pipe = Pipeline(app) | XImageSum(app).bind(params=CombineParams())
    before = compile_cache_stats()
    n_data = len(app._data)
    with pytest.raises(PortError, match="missing required arrays"):
        pipe.build(XData({"img": np.zeros((4, 4), np.float32)}))
    assert compile_cache_stats() == before
    assert len(app._data) == n_data


def test_compile_cache_stats_repeat_run_compiles_nothing(rec, app):
    """A pipeline's runs with fresh input Data: the port compiles (captures)
    on the second run, as every launch does, and from then on a run is a
    hit (a replay) and never a miss."""
    pipe = Pipeline(app) | TAddConst(app).bind(params=2.0)
    rng = np.random.default_rng(9)
    pipe.run(XData({"img": _img(rng, (7, 3))}))
    h0, m0 = compile_cache_stats()
    pipe.run(XData({"img": _img(rng, (7, 3))}))
    h1, m1 = compile_cache_stats()
    assert (h1 - h0, m1 - m0) == (1, 1)
    x = _img(rng, (7, 3))
    got = pipe.run(XData({"img": x}))
    h2, m2 = compile_cache_stats()
    assert (h2 - h1, m2) == (1, m1), "repeat run must not capture again"
    np.testing.assert_array_equal(got.get_ndarray(0).host, x + 2.0)


def test_compile_cache_stats_ragged_tail_compiles_a_second_twin(rec, app):
    """9 items at batch 8: the tail runs through a twin of its own.  Each
    twin launches once a stream, so the port captures both (main and tail:
    2 misses) on the second stream, as the JAX package compiles both on
    the first; a third stream compiles nothing."""
    d_in = XData({"img": np.zeros((3, 17), np.float32)})
    p = TScale(app)
    p.in_handle, p.out_handle = app.addData(d_in), app.addData(XData(d_in, copy_values=False))
    p.set_launch_parameters(3.0)
    p.init()
    rng = np.random.default_rng(10)
    xs = [_img(rng, (3, 17)) for _ in range(9)]
    misses = []
    for _ in range(3):
        m0 = compile_cache_stats()[1]
        outs = p.stream([XData({"img": x}) for x in xs], batch=8, sync=True)
        misses.append(compile_cache_stats()[1] - m0)
    assert misses == [0, 2, 0]
    assert sorted(p._stream_twins) == [(1, 0), (1, 1), (8, 0), (8, 1)]
    for x, o in zip(xs, outs):
        np.testing.assert_allclose(o.get_ndarray(0).host, x * 3.0, rtol=1e-6)
