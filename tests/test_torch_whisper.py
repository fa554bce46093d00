"""The port's Whisper serving path (the encdec family) against the JAX
package's, on whisper-large-v3's SMOKE config (2 encoder and 2 decoder
layers, d 64, 4 heads of 16, vocab 128), float32, with 8 encoder positions.
The JAX side runs its Pallas kernels in interpret mode (``use_pallas=True``:
the encoder's non-causal and the decoder prefill's causal flash attention),
as ``tests/test_torch_lm.py`` does; its parameters (64 learned decoder
positions) are carried across with ``interop.params_from_reference``, so
both packages compute the same function.

What is compared: the carried weight bytes; ``attention_full`` causal and
not; ``encode``; the prefill logits and every cache leaf (self k, v, kpos,
cross_k, cross_v); 6 decode steps; ``DecodeSession(enc_len=8)``, whose
prefill is the fan-in graph frames -> ``WhisperEncode`` ~ tokens ->
``WhisperPrefill`` joined on the ``enc`` edge (kept on the device);
``LMServer`` with 4 frame-carrying requests through 2 slots; ``ServeEngine``
against ``LMServer``; the four refusals of frames and ``enc_len``; and
``repro_torch.launch.serve_lm --cpu``.

Tolerances: logits and floating cache leaves at rtol 1e-4 / atol 1e-5 (f32,
two frameworks summing in other orders); weight bytes, tokens, cache
positions and arena layouts exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, get_smoke as j_get_smoke
from repro.core import arena as jarena
from repro.core.app import CLapp as JApp
from repro.models import build_model as j_build_model
from repro.models import layers as jL
from repro.processes import lm as jlm
from repro.serve import (LMServer as JServer, SamplingConfig as JSampling,
                         ServeEngine as JEngine)
from repro_torch import interop
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import CLapp, Coherence, DeviceTraits, DeviceType
from repro_torch.models import WhisperModel, build_model
from repro_torch.models import layers as tL
from repro_torch.models.common import tree_flatten, tree_map
from repro_torch.processes import lm as tlm
from repro_torch.serve import LMServer, SamplingConfig, ServeEngine

ARCH = "whisper-large-v3"
TOL = dict(rtol=1e-4, atol=1e-5)
MAX_LEN, ENC_LEN, POSITIONS = 24, 8, 64


@functools.lru_cache(maxsize=None)
def _jax():
    model = j_build_model(j_get_smoke(ARCH).scaled(use_pallas=True))
    return model, model.init_params(jax.random.key(0), max_dec_positions=POSITIONS)


def _named(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port():
    """(model, weights Data on the CPU, parameter tree of its views)."""
    model = build_model(get_smoke(ARCH))
    weights = interop.params_from_reference(_named(_jax()[1]), model.cfg, "cpu")
    params = tlm.TreeCodec(model.param_specs(POSITIONS), prefix="w").unflatten(
        weights.device_views())
    return model, weights, params


def _cpu_app():
    return CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))


def _entries(layout):
    return [(e.name, e.shape, e.dtype, e.offset, e.nbytes) for e in layout.entries], \
        layout.total_bytes


def _frames(rng, *lead):
    return rng.standard_normal(lead + (ENC_LEN, get_smoke(ARCH).d_model)).astype(np.float32)


def test_weights_and_state_layouts_match_reference():
    jmodel, jparams = _jax()
    model, weights, _ = _port()
    assert isinstance(model, WhisperModel) and model.kernel_names == ("flash_attention",)
    jw, _ = jlm.weights_data(jparams)
    tw, codec = tlm.weights_data(model.param_specs(POSITIONS))
    assert _entries(tw.plan()) == _entries(jw.plan())
    assert codec.names == tuple(jw.names)
    assert _entries(weights.layout) == _entries(jw.layout)
    assert weights.device_blob.numpy().tobytes() == np.asarray(jw.pack_host()).tobytes()
    js, jcodec = jlm.decode_state_data(jmodel, 3, MAX_LEN, ENC_LEN)
    ts, tcodec = tlm.decode_state_data(model, 3, MAX_LEN, ENC_LEN)
    assert _entries(ts.plan()) == _entries(js.plan())
    assert tcodec.names == jcodec.names


def test_full_width_layouts_match_reference():
    """whisper-large-v3 uncut in bfloat16 (1.58 G parameters, 32776 decoder
    positions) and a 4 x 448 decode state over 1500 encoder positions plan
    to the same entries and offsets in both packages, nothing allocated."""
    jmodel = j_build_model(j_get_config(ARCH))
    shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.key(0)))
    jcodec = jlm.TreeCodec(shapes, prefix="w")
    jl = jarena.plan_layout((n, leaf.shape, leaf.dtype) for n, leaf in
                            zip(jcodec.names, jax.tree_util.tree_leaves(shapes)))
    model = build_model(get_config(ARCH))
    tw, _ = tlm.weights_data(model.param_specs())
    assert _entries(tw.plan()) == _entries(jl)
    assert {e.dtype for e in tw.layout.entries} == {"bfloat16"}
    assert sum(int(np.prod(e.shape)) for e in tw.layout.entries) == 1_577_172_480
    js, _ = jlm.decode_state_data(jmodel, 4, 448, 1500)
    ts, _ = tlm.decode_state_data(model, 4, 448, 1500)
    assert _entries(ts.plan()) == _entries(js.plan())


def test_carried_positions_follow_the_array_and_a_wrong_width_raises():
    """``pos_dec`` keeps the rows it has (64 here, 32776 by default); a
    width other than d_model is refused, naming the path."""
    named = _named(_jax()[1])
    cfg = get_smoke(ARCH)
    weights = interop.params_from_reference(named, cfg, "cpu")
    assert weights.specs()["w['pos_dec']"].shape == (POSITIONS, 64)
    wrong = dict(named, **{"['pos_dec']": named["['pos_dec']"][:, :32]})
    with pytest.raises(ValueError, match=r"\['pos_dec'\]: shape \(64, 32\), "
                                         r"whisper-large-v3 has \(64, 64\)"):
        interop.params_from_reference(wrong, cfg, "cpu")


def test_init_params_fills_each_leaf_by_its_role():
    model = build_model(get_smoke(ARCH))
    params = model.init_params(torch.Generator().manual_seed(0), max_dec_positions=512)
    leaves = dict(tree_flatten(params))
    assert leaves["['pos_dec']"].shape == (512, 64)
    assert abs(float(leaves["['pos_dec']"].std()) - 0.02) < 2e-3
    assert torch.equal(leaves["['enc_norm']['scale']"], torch.ones(64))
    assert not leaves["['dec_layers']['mlp']['b_up']"].any()
    # fan-in of a stacked leaf is its per-layer first axis: d_model = 64
    w_k = leaves["['dec_layers']['cross_attn']['w_k']"]
    assert w_k.shape == (2, 64, 64) and abs(float(w_k.std()) - 64 ** -0.5) < 0.02


@pytest.mark.parametrize("causal", [False, True], ids=["encoder", "causal"])
def test_attention_full_matches_reference(causal, rng):
    jcfg, tcfg = j_get_smoke(ARCH).scaled(use_pallas=True), get_smoke(ARCH)
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
         for k, s in tL.attention_specs(tcfg).items()}
    x = rng.standard_normal((2, 11, tcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(11, dtype=np.int32), (2, 1))
    want = jL.attention_full({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
                             jnp.asarray(pos), causal=causal)
    got = tL.attention_full(tree_map(torch.from_numpy, p), torch.from_numpy(x), tcfg,
                            torch.from_numpy(pos), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_matches_reference(rng):
    jmodel, jparams = _jax()
    model, _, params = _port()
    frames = _frames(rng, 2)
    want = jax.jit(jmodel.encode)(jparams, jnp.asarray(frames))
    np.testing.assert_allclose(model.encode(params, torch.from_numpy(frames)).numpy(),
                               np.asarray(want), **TOL)


def test_prefill_and_decode_match_reference(rng):
    """Prefill a 5-token prompt over 8 frames, then 6 decode steps (both
    sides fed the JAX argmax): logits and every cache leaf agree, the
    tokens exactly."""
    jmodel, jparams = _jax()
    model, _, params = _port()
    b, s = 2, 5
    frames = _frames(rng, b)
    tokens = rng.integers(0, model.cfg.vocab, (b, s)).astype(np.int32)
    jl, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(frames), jnp.asarray(tokens),
                                         jmodel.init_cache(b, MAX_LEN, ENC_LEN))
    tl, tcache = model.prefill(params, torch.from_numpy(frames), torch.from_numpy(tokens),
                               model.init_cache(b, MAX_LEN, ENC_LEN))
    step = jax.jit(jmodel.decode_step)
    names = ["['cross_k']", "['cross_v']", "['self']['k']", "['self']['kpos']",
             "['self']['v']"]
    for i in range(7):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jnp.argmax(jl, -1)))
        jleaves = _named(jcache)
        assert sorted(jleaves) == [name for name, _ in tree_flatten(tcache)] == names
        for name, leaf in tree_flatten(tcache):
            if leaf.dtype.is_floating_point:
                np.testing.assert_allclose(leaf.numpy(), jleaves[name], err_msg=name, **TOL)
            else:
                np.testing.assert_array_equal(leaf.numpy(), jleaves[name], err_msg=name)
        if i == 6:
            break
        tok = np.array(jnp.argmax(jl, axis=-1).astype(jnp.int32))
        jl, jcache = step(jparams, jnp.asarray(tok), jnp.int32(s + i), jcache)
        tl, tcache = model.decode_step(params, torch.from_numpy(tok),
                                       torch.tensor(s + i, dtype=torch.int32), tcache)


def test_decode_session_fanin_prefill_matches_reference(rng):
    """frames -> WhisperEncode ~ tokens -> WhisperPrefill, joined on
    ``enc``: the same tokens as the JAX DecodeSession; the ``enc`` edge is
    planned on the device, never uploaded and never given host arrays."""
    jmodel, jparams = _jax()
    model, weights, _ = _port()
    prompts = rng.integers(0, model.cfg.vocab, (2, 3)).astype(np.int32)
    frames = _frames(rng, 2)
    jsess = jlm.DecodeSession(JApp().init(), jmodel, jparams, batch=2, max_len=MAX_LEN,
                              enc_len=ENC_LEN)
    app = _cpu_app()
    tsess = tlm.DecodeSession(app, model, weights, batch=2, max_len=MAX_LEN, enc_len=ENC_LEN)
    np.testing.assert_array_equal(tsess.prefill(prompts, frames=frames),
                                  jsess.prefill(prompts, frames=frames))
    for _ in range(5):
        np.testing.assert_array_equal(tsess.step(), jsess.step())
    pipe = tsess.prefill_pipe
    built = pipe.build()
    assert [type(s).__name__ for s in built.executor.stages] == ["WhisperEncode",
                                                                  "WhisperPrefill"]
    assert set(pipe.input_edges) == {"frames", "tokens"}
    assert pipe.residency_plan["enc"] == "device"
    enc_h = built.executor.stages[0].out_handle
    enc = app.getData(enc_h)
    assert app.h2d_bytes.get(enc_h, 0) == 0 and all(a.host is None for a in enc)
    assert enc.coherence is Coherence.DEVICE_RESIDENT
    assert all(app.h2d_bytes[built.input_handles[e]] > 0 for e in ("frames", "tokens"))
    assert app.h2d_bytes.get(tsess.state_h, 0) == 0
    assert tsess.state.coherence is Coherence.DEVICE_RESIDENT


def _requests(rng, lengths=(3, 6, 4, 3)):
    return [(list(rng.integers(0, 128, n)), _frames(rng)) for n in lengths]


def test_lmserver_matches_reference(rng):
    """4 requests with their own frames through 2 slots: later requests are
    admitted into freed slots while others decode, a prompt length comes
    twice with other frames, and every request's tokens equal the JAX
    LMServer's.  The decode state never moves host to device; each prompt
    and its frames are uploaded once."""
    jmodel, jparams = _jax()
    model, weights, _ = _port()
    app = _cpu_app()
    jsrv = JServer(jmodel, jparams, batch=2, max_len=MAX_LEN, enc_len=ENC_LEN,
                   sampling=JSampling(max_new_tokens=6))
    tsrv = LMServer(model, weights, batch=2, max_len=MAX_LEN, enc_len=ENC_LEN,
                    sampling=SamplingConfig(max_new_tokens=6), app=app)
    for prompt, frames in _requests(rng):
        jsrv.submit(prompt, frames=frames)
        tsrv.submit(prompt, frames=frames[None])
    want = jsrv.run()
    assert tsrv.run() == want
    assert all(len(r) == 6 for r in want)
    assert (tsrv.steps, tsrv.admitted) == (jsrv.steps, jsrv.admitted) and tsrv.admitted == 4
    assert sorted(tsrv._prefill_pipes) == [3, 4, 6]
    assert app.h2d_bytes.get(tsrv.state_h, 0) == 0 and app.h2d_bytes.get(tsrv._row_h, 0) == 0
    assert tsrv.decode_profile.phase_total("transfer") == 0.0
    # a prompt and its frames each, and the zero state's (the JAX LMServer's first splice's)
    assert len(tsrv.prefill_profile.phases["transfer"]) == 8 + 1


def test_lmserver_frames_buffer_does_not_grow_with_prompt_lengths(rng):
    """7 requests of 7 distinct prompt lengths build 7 prefill pipes, and
    all of them read the server's one frames Data: one registered Data
    holds frames, its blob never moves, and each request uploads its
    frames into it once.  Each request's first token equals that of a
    server that saw only it, so no prefill read another request's frames."""
    model, weights, _ = _port()
    app = _cpu_app()
    reqs = _requests(rng, (1, 2, 3, 4, 5, 6, 7))
    srv = LMServer(model, weights, batch=2, max_len=MAX_LEN, enc_len=ENC_LEN,
                   sampling=SamplingConfig(max_new_tokens=2), app=app)
    for prompt, frames in reqs:
        srv.submit(prompt, frames)
    srv.step()
    blob = app.getData(srv._frames_h).device_blob
    out = srv.run()
    assert sorted(srv._prefill_pipes) == [1, 2, 3, 4, 5, 6, 7]
    holders = [h for h, d in app._data.items() if "frames" in d.names]
    assert holders == [srv._frames_h]
    assert app.getData(srv._frames_h).device_blob is blob
    assert app.h2d_bytes[srv._frames_h] == len(reqs) * reqs[0][1].nbytes
    for (prompt, frames), toks in zip(reqs, out):
        alone = LMServer(model, weights, batch=1, max_len=MAX_LEN, enc_len=ENC_LEN,
                         sampling=SamplingConfig(max_new_tokens=1), app=_cpu_app())
        alone.submit(prompt, frames)
        assert alone.run()[0][0] == toks[0]


def test_serve_engine_matches_lmserver_and_reference(rng):
    jmodel, jparams = _jax()
    model, weights, _ = _port()
    reqs = _requests(rng, (5, 3, 5))
    outs = {}
    for name, srv in (
            ("jax", JEngine(jmodel, jparams, batch=2, max_len=MAX_LEN, enc_len=ENC_LEN,
                            sampling=JSampling(max_new_tokens=4))),
            ("engine", ServeEngine(model, weights, batch=2, max_len=MAX_LEN, enc_len=ENC_LEN,
                                   sampling=SamplingConfig(max_new_tokens=4), app=_cpu_app())),
            ("server", LMServer(model, weights, batch=2, max_len=MAX_LEN, enc_len=ENC_LEN,
                                sampling=SamplingConfig(max_new_tokens=4), app=_cpu_app()))):
        for prompt, frames in reqs:
            srv.submit(prompt, frames)
        outs[name] = srv.run()
    assert outs["engine"] == outs["server"] == outs["jax"]


@pytest.mark.parametrize("case", ["no_enc_len", "no_frames", "frames_on_dense",
                                  "wrong_enc_len"])
def test_frames_and_enc_len_are_validated(case):
    """The JAX LMServer's four refusals, word for word."""
    model, weights, _ = _port()
    kw = dict(batch=1, max_len=8, app=_cpu_app())
    if case == "no_enc_len":
        with pytest.raises(ValueError, match="encoder-decoder models need enc_len"):
            LMServer(model, weights, **kw)
        return
    if case == "frames_on_dense":
        dense = build_model(get_smoke("qwen3-14b"))
        srv = LMServer(dense, dense.init_params(torch.Generator().manual_seed(0)), **kw)
        with pytest.raises(ValueError, match="'dense' models take no frames"):
            srv.submit([1, 2], frames=np.zeros((ENC_LEN, 64), np.float32))
        return
    srv = LMServer(model, weights, enc_len=ENC_LEN, **kw)
    if case == "no_frames":
        with pytest.raises(ValueError, match="encoder-decoder models take per-request frames"):
            srv.submit([1, 2])
    else:
        with pytest.raises(ValueError, match="frames cover 7 encoder positions but the decode "
                                             "state was compiled for enc_len=8"):
            srv.submit([1, 2], frames=np.zeros((7, 64), np.float32))
    assert not srv.queue


def test_decode_full_matches_reference(rng):
    """The teacher-forced decoder (the training forward's) over encoder
    states: logits (B, S, V) f32 against the reference's with its Pallas
    kernels in interpret mode, at the serving tolerance."""
    jmodel, jparams = _jax()
    model, _, params = _port()
    enc = rng.standard_normal((2, ENC_LEN, model.cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, model.cfg.vocab, (2, 9)).astype(np.int32)
    want = jax.jit(jmodel.decode_full)(jparams, jnp.asarray(tokens), jnp.asarray(enc))
    got = model.decode_full(params, torch.from_numpy(tokens), torch.from_numpy(enc))
    assert got.shape == (2, 9, model.cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_serve_lm_example_on_a_cpu_app(capsys):
    from repro_torch.launch import serve_lm

    out = serve_lm.main(["--cpu"])
    assert [len(r) for r in out["qwen3-14b"]] == [16] * 10
    assert [len(r) for r in out["whisper"]] == [8] * 4
    text = capsys.readouterr().out
    assert "decode-side host2device on the cache edge: 0.000000s" in text
    assert "all requests completed" in text
