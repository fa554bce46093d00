"""The port's serving layer on the CPU: ``PipelineServer`` (dynamic
batching with redrain, multi-tensor requests, the ``flush_timeout``
background drain, its validation and error paths, ``warmup()`` capturing
every twin before the worker thread starts) against the JAX package's
``PipelineServer`` at SMOKE size, and ``ServeEngine`` (the former LM API,
a shim over ``LMServer``) against the port's ``LMServer`` and the JAX
package's ``ServeEngine``.

Tolerances: plain processes (no FFT) bit for bit against their per-item
math; the MRI reconstruction against the JAX package at rtol/atol 1e-4
(``docs/kernels.md`` §3); greedy tokens exactly.
"""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import processes as jproc
from repro.serve import ServeEngine as JEngine, SamplingConfig as JSampling
from repro.serve.engine import sample_tokens as j_sample_tokens
import repro_torch.core as tcore
from repro_torch.configs.mri_recon import SMOKE
from repro_torch.core import CLapp, DeviceTraits, DeviceType, Pipeline, PortError, XData
from repro_torch.processes import SimpleMRIRecon
from repro_torch.serve import (LMServer, SamplingConfig, ServeEngine, ServeResponse,
                               make_decode_fn, make_prefill_fn, sample_tokens)
from test_torch_compiled_launch import rec  # noqa: F401  (the recorder fixture)
from test_torch_lm import _jax, _port

SHAPE = (SMOKE.frames, SMOKE.coils, SMOKE.height, SMOKE.width)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)


class Scale(tcore.Process):
    batch_axis = True

    def apply(self, views, aux, params, out=None):
        return {k: v * params for k, v in views.items()}


class AddConst(tcore.Process):
    batch_axis = True

    def apply(self, views, aux, params, out=None):
        return {k: v + params for k, v in views.items()}


class AddTwo(tcore.Process):
    batch_axis = True
    ports = {"in": tcore.Port(names=("img",)), "out": tcore.Port(names=("img",)),
             "rhs": tcore.Port(names=("img",))}

    def apply(self, views, aux, params, out=None):
        return {"img": views["img"] + aux["rhs"]["img"]}


@pytest.fixture
def app():
    return CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))


def _img(rng, shape=(4, 9)):
    return XData({"img": rng.standard_normal(shape).astype(np.float32)})


def _host(d):
    return d.get_ndarray(0).host


def _out(resp):
    resp.data.sync_to_host()
    return _host(resp.data)


def test_dynamic_batching_and_redrain(app, rng):
    pipe = Pipeline(app) | Scale(app).bind(params=-1.5)
    server = pipe.serve(batch=4)
    datasets = [_img(rng) for _ in range(6)]
    rids = [server.submit(d) for d in datasets]
    assert rids == list(range(6)) and server.pending == 6
    responses = server.drain()
    assert server.pending == 0 and server.served == 6
    assert server.launches == 2, "6 requests at batch=4 -> two launches"
    assert all(isinstance(r, ServeResponse) and r.latency_s > 0 for r in responses)
    by_rid = {r.rid: r for r in responses}
    for rid, d in zip(rids, datasets):
        np.testing.assert_array_equal(_out(by_rid[rid]), _host(d) * np.float32(-1.5))
    # a second wave reuses the twins
    twins = dict(pipe.build().executor._stream_twins)
    more = [_img(rng) for _ in range(3)]
    rids2 = [server.submit(d) for d in more]
    assert rids2 == [6, 7, 8]
    resp2 = server.drain()
    assert {r.rid for r in resp2} == {6, 7, 8}
    assert pipe.build().executor._stream_twins == twins
    assert server.drain() == []


def test_requests_snapshot_their_data_at_submit(app, rng):
    """Admission takes a host snapshot: a request's arrays changed after
    submit() do not change its result."""
    pipe = Pipeline(app) | Scale(app).bind(params=2.0)
    server = pipe.serve(batch=2)
    d = _img(rng)
    want = _host(d) * np.float32(2.0)
    server.submit(d)
    d.get_ndarray(0).host[...] = 0.0
    np.testing.assert_array_equal(_out(server.drain()[0]), want)


def test_server_rejects_wrong_layout_and_bad_options(app, rng):
    pipe = Pipeline(app) | Scale(app).bind(params=2.0)
    server = pipe.serve(batch=2)
    with pytest.raises(RuntimeError, match="not built"):
        server.input_edges
    server.submit(_img(rng, (6, 5)))
    with pytest.raises(PortError, match="layout"):
        server.submit(_img(rng, (3, 3)))
    with pytest.raises(ValueError, match="flush_timeout"):
        pipe.serve(flush_timeout=0.0)
    with pytest.raises(ValueError, match="batch"):
        pipe.serve(batch=0)
    with pytest.raises(RuntimeError, match="not built"):
        (Pipeline(app) | Scale(app).bind(params=1.0)).serve().warmup()


def test_server_multi_tensor_requests(app, rng):
    a = AddConst(app).bind(infile="x", outfile="lhs", params=1.0)
    j = AddTwo(app).bind(infile="lhs", outfile="sum", rhs="r")
    pipe = Pipeline.from_graph(app, [a, j], output="sum")
    server = pipe.serve(batch=4)
    reqs = [{"x": _img(rng), "r": _img(rng)} for _ in range(6)]
    rids = [server.submit(q) for q in reqs]
    assert server.input_edges == ("x", "r")
    responses = {r.rid: r for r in server.drain()}
    assert server.launches == 2
    for rid, q in zip(rids, reqs):
        np.testing.assert_array_equal(_out(responses[rid]),
                                      (_host(q["x"]) + 1.0) + _host(q["r"]))
    with pytest.raises(PortError, match="layout"):
        server.submit({"x": _img(rng, (2, 2)), "r": _img(rng, (2, 2))})


def test_flush_timeout_background_drain(app, rng):
    """A partial batch is flushed by the background thread once its oldest
    request waited flush_timeout; a full batch goes at once; drain()
    forces a flush; close() stops the thread and closes the server."""
    pipe = Pipeline(app) | Scale(app).bind(params=-3.0)
    server = pipe.serve(batch=8, flush_timeout=0.05)
    try:
        server.submit(_img(rng))
        server.collect(1, timeout=30.0)
        ds = [_img(rng) for _ in range(3)]
        rids = [server.submit(d) for d in ds]
        resp = server.collect(3, timeout=30.0)
        assert len(resp) == 3, "flush_timeout never flushed"
        by_rid = {r.rid: r for r in resp}
        for rid, d in zip(rids, ds):
            np.testing.assert_array_equal(_out(by_rid[rid]), _host(d) * np.float32(-3.0))
            assert by_rid[rid].latency_s >= 0.04, "a partial batch waits ~flush_timeout"
        rids = [server.submit(_img(rng)) for _ in range(8)]
        resp = server.collect(8, timeout=30.0)
        assert {r.rid for r in resp} == set(rids)
        assert min(r.latency_s for r in resp) < 0.05, "a full batch does not wait"
        server.submit(_img(rng))
        assert len(server.drain()) == 1
    finally:
        server.close()
    assert server._worker is None
    for call in (lambda: server.submit(_img(rng)), server.drain, lambda: server.collect(1)):
        with pytest.raises(RuntimeError, match="closed"):
            call()
    server.close()                               # idempotent


def test_close_flushes_what_is_pending(app, rng):
    pipe = Pipeline(app) | Scale(app).bind(params=2.0)
    server = pipe.serve(batch=8, flush_timeout=30.0)
    ds = [_img(rng) for _ in range(3)]
    for d in ds:
        server.submit(d)
    server.close()                               # well before the timeout
    assert server.served == 3 and server.pending == 0
    got = {r.rid: r for r in server._completed}
    for rid, d in enumerate(ds):
        np.testing.assert_array_equal(_out(got[rid]), _host(d) * np.float32(2.0))


def test_collect_without_background_thread_fails_fast(app, rng):
    pipe = Pipeline(app) | Scale(app).bind(params=1.0)
    server = pipe.serve(batch=4)
    server.submit(_img(rng))
    with pytest.raises(RuntimeError, match="flush_timeout"):
        server.collect(1, timeout=5.0)


def test_worker_death_surfaces_to_callers(app, rng):
    pipe = Pipeline(app) | Scale(app).bind(params=1.0)
    server = pipe.serve(batch=8, flush_timeout=0.02)
    try:
        server.submit(_img(rng))
        server.collect(1, timeout=30.0)

        def boom(items):
            raise RuntimeError("injected launch failure")
        server._plan.stack_group = boom
        server.submit(_img(rng))
        for call in (lambda: server.collect(1, timeout=30.0), lambda: server.submit(_img(rng)),
                     server.drain):
            with pytest.raises(RuntimeError, match="drain thread died") as err:
                call()
            assert "injected launch failure" in str(err.value.__cause__)
    finally:
        server.close()


def test_warmup_captures_every_twin_before_the_worker(rec, app, rng, monkeypatch):
    """Compiled as on the card (the recorder of test_torch_compiled_launch):
    warmup() launches every twin a drain can use (rows 4 and, the tail
    policy's twin, 1; both upload slots) until it captured, in the calling
    thread; the worker then only replays (no capture in its thread), and
    warmup() after the worker started is refused."""
    pipe = Pipeline(app) | Scale(app).bind(params=2.0)
    server = pipe.serve(batch=4, flush_timeout=0.02)
    captured_in = []
    capture = rec.__call__

    class Spy:
        def __call__(self, body, device):
            captured_in.append(threading.current_thread().name)
            return capture(body, device)
    monkeypatch.setattr(tcore.process, "capture_graph", Spy())
    server.warmup(_img(rng))
    twins = pipe.build().executor._stream_twins
    assert sorted(twins) == [(1, 0), (1, 1), (4, 0), (4, 1)]
    assert all(bp.captures == 1 for bp in twins.values())
    assert captured_in == [threading.current_thread().name] * 4
    try:
        ds = [_img(rng) for _ in range(9)]
        for d in ds:
            server.submit(d)
        resp = {r.rid: r for r in server.collect(9, timeout=30.0)}
        for rid, d in enumerate(ds):
            np.testing.assert_array_equal(_out(resp[rid]), _host(d) * np.float32(2.0))
        with pytest.raises(RuntimeError, match="before the first submit"):
            server.warmup()
    finally:
        server.close()
    assert len(captured_in) == 4 and all(bp.captures == 1 for bp in twins.values())


def test_concurrent_submitters_lose_no_request(app, rng):
    """16 threads submitting 6 requests each to a background-drained server
    (the thread switch interval shortened): every request id is unique and
    every response arrives with its own result."""
    pipe = Pipeline(app) | Scale(app).bind(params=3.0)
    server = pipe.serve(batch=5, flush_timeout=0.005)
    data = {}
    lock = threading.Lock()

    def submitter(t):
        for i in range(6):
            d = XData({"img": np.full((4, 9), t * 100 + i, np.float32)})
            rid = server.submit(d)
            with lock:
                data[rid] = t * 100 + i

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        server.submit(XData({"img": np.zeros((4, 9), np.float32)}))   # builds it
        server.collect(1, timeout=30.0)
        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        resp = server.collect(96, timeout=60.0)
    finally:
        sys.setswitchinterval(old)
        server.close()
    assert len(data) == 96 and len(resp) == 96
    for r in resp:
        assert float(_out(r)[0, 0]) == data[r.rid] * 3.0


def _mri_items(mod, n, seed=5):
    rng = np.random.default_rng(seed)
    f, c, h, w = SHAPE
    out = []
    for _ in range(n):
        k = (rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)
        s = (rng.standard_normal((c, h, w)) + 1j * rng.standard_normal((c, h, w))
             ).astype(np.complex64)
        out.append(mod.KData({"kdata": k, "sensitivity_maps": s}))
    return out


@pytest.mark.parametrize("mode,jmode", [("staged", "staged"), ("fused_kernel", "fused_pallas")])
def test_mri_server_matches_jax(app, mode, jmode):
    """A SimpleMRIRecon pipeline served at batch 2 (5 requests: a padded
    tail) in both packages: every response within 1e-4 of the JAX
    package's, in submit order through run(mode="serve"), each latency
    recorded."""
    japp = jcore.CLapp().init()
    jpipe = jcore.Pipeline(japp) | jproc.SimpleMRIRecon(japp, mode=jmode, in_place=False).bind()
    jserver = jpipe.serve(batch=2)
    jrids = [jserver.submit(d) for d in _mri_items(jcore, 5)]
    jout = {r.rid: np.asarray(r.data.device_views()["xdata"]) for r in jserver.drain()}
    pipe = Pipeline(app) | SimpleMRIRecon(app, mode=mode, in_place=False).bind()
    server = pipe.serve(batch=2)
    rids = [server.submit(d) for d in _mri_items(tcore, 5)]
    assert rids == jrids
    resp = {r.rid: r for r in server.drain()}
    assert server.launches == 3
    for rid in rids:
        np.testing.assert_allclose(_out(resp[rid]), jout[rid], **JAX_TOL)
    prof = tcore.ProfileParameters(enable=True)
    outs = pipe.run(_mri_items(tcore, 5), mode="serve", batch=2, profile=prof)
    assert len(prof.samples) == 5 and all(t > 0 for t in prof.samples)
    for rid, o in zip(rids, outs):
        np.testing.assert_array_equal(_host(o), _out(resp[rid]))


# ---------------------------------------------------------------------------
# ServeEngine and the sampling helpers
# ---------------------------------------------------------------------------

def test_serve_engine_tokens_match_lmserver_and_jax():
    """The former API on the port's LMServer: 4 prompts through 2 slots,
    5 new tokens; its tokens equal the port's LMServer's and the JAX
    package's ServeEngine's (qwen3-14b at SMOKE size, interpret-mode
    Pallas kernels on the JAX side)."""
    arch = "qwen3-14b"
    jmodel, jparams = _jax(arch)
    model, weights = _port(arch)
    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(0, model.cfg.vocab, n)) for n in (3, 9, 5, 7)]
    jeng = JEngine(jmodel, jparams, batch=2, max_len=24, sampling=JSampling(max_new_tokens=5))
    cpu = DeviceTraits(type=DeviceType.CPU)
    eng = ServeEngine(model, weights, batch=2, max_len=24,
                      sampling=SamplingConfig(max_new_tokens=5), app=CLapp().init(
                          device_traits=cpu))
    srv = LMServer(model, weights, batch=2, max_len=24, sampling=SamplingConfig(max_new_tokens=5),
                   app=CLapp().init(device_traits=cpu))
    for p in prompts:
        jeng.submit(p)
        eng.submit(p)
        srv.submit(p)
    want = jeng.run()
    got = eng.run()
    assert got == srv.run() == want
    assert eng.results is eng.server.results and not eng.queue and not eng.active.any()
    assert eng.positions.shape == eng.req_of_slot.shape == (2,)


def test_sample_tokens_and_model_fns():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 1, 50)).astype(np.float32)
    greedy = sample_tokens(torch.from_numpy(logits), SamplingConfig())
    want = np.asarray(j_sample_tokens(jnp.asarray(logits), JSampling(), jax.random.key(0)))
    np.testing.assert_array_equal(greedy.numpy(), want)
    assert greedy.dtype == torch.int32 and tuple(greedy.shape) == (3, 1)
    # top-k sampling: other random numbers than JAX's, so the support is
    # what is compared: every draw among the k largest logits of its row
    cfg = SamplingConfig(temperature=0.7, top_k=4)
    gen = torch.Generator().manual_seed(0)
    top = np.argsort(logits, axis=-1)[..., -4:]
    for _ in range(20):
        toks = sample_tokens(torch.from_numpy(logits), cfg, gen).numpy()
        assert all(toks[b, 0] in top[b, 0] for b in range(3))

    class Model:
        def prefill(self, params, tokens, cache):
            return ("prefill", params, tokens, cache)

        def decode_step(self, params, token, pos, cache):
            return ("decode", params, token, pos, cache)
    assert make_prefill_fn(Model())(1, 2, 3) == ("prefill", 1, 2, 3)
    assert make_decode_fn(Model())(1, 2, 3, 4) == ("decode", 1, 2, 3, 4)
