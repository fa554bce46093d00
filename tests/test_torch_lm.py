"""The port's LM serving path against the JAX package's, on the SMOKE
configs of qwen3-14b (qk-norm), h2o-danube-1.8b (sliding window 8, so a
12-token prompt takes the rolling-buffer prefill), qwen2-7b (QKV bias),
minitron-8b (squared-ReLU MLP, rotary on half the head), granite-moe-1b-a400m
(MoE, top-2 of 4 experts at SMOKE), deepseek-v2-lite-16b (MLA attention,
MoE with a shared expert, a dense layer 0 outside the stack), rwkv6-3b
(the ssm family: a recurrent state instead of a K/V cache), zamba2-2.7b
(the hybrid family: Mamba2 layers and one shared attention block) and
internvl2-2b (the vlm family, served text-only as the JAX ``LMServer``
serves it), all float32.  The JAX side runs its Pallas kernels in interpret mode
(``use_pallas=True``), as ``tests/test_kernels.py`` does; its parameters are
carried across with ``interop.params_from_reference``, so both packages
compute the same function.

Tolerances: arena layouts, carried-over weight bytes, cache positions and
greedy tokens are compared exactly; logits and cache leaves at rtol 1e-4 /
atol 1e-5 (f32, two frameworks summing in other orders), except RWKV6's WKV
state and Zamba2's SSM state, at atol 1e-5 x max |state|: each entry is a
decayed sum of products over the prompt, so its rounding error scales with
those terms (up to about 10 here), not with the entry.
"""
import contextlib
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, get_smoke as j_get_smoke
from repro.core import arena as jarena
from repro.core.app import CLapp as JApp
from repro.models import common as jcommon
from repro.models import build_model as j_build_model
from repro.processes import lm as jlm
from repro.serve import LMServer as JServer, SamplingConfig as JSampling
from repro_torch import interop
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import (CLapp, Coherence, DeviceTraits, DeviceType,
                              NoMatchingDeviceError)
from repro_torch.models import build_model
from repro_torch.models.common import tree_flatten, tree_map
from repro_torch.models.rwkv6 import RWKV6Model
from repro_torch.processes import lm as tlm
from repro_torch.serve import LMServer, PromptTooLongError, SamplingConfig

ARCHS = ["qwen3-14b", "h2o-danube-1.8b", "qwen2-7b", "minitron-8b", "granite-moe-1b-a400m",
         "deepseek-v2-lite-16b", "rwkv6-3b", "zamba2-2.7b", "internvl2-2b"]
#: the JAX LMServer writes every admitted zamba2 row into slot 0 (its
#: slot-axis guess); zamba2's servers are compared in test_torch_zamba2.py
SERVED_ALIKE = [a for a in ARCHS if a != "zamba2-2.7b"]
LOGITS = dict(rtol=1e-4, atol=1e-5)
MAX_LEN = 24


@contextlib.contextmanager
def stable_keys():
    """The JAX package's ``KeyGen`` folds ``abs(hash(name))`` into its key,
    and Python salts ``hash`` of a string per process (``PYTHONHASHSEED``),
    so its seed-0 parameters differ from one test process to the next (the
    cause of the rare 1e-5 misses these comparisons used to show).  Inside
    this block it folds a CRC-32 of the name instead: every process draws
    the same parameters.  Nothing in the JAX package changes."""
    call = jcommon.KeyGen.__call__
    jcommon.KeyGen.__call__ = lambda self, name: jax.random.fold_in(
        self.key, zlib.crc32(name.encode()) % (2 ** 31))
    try:
        yield
    finally:
        jcommon.KeyGen.__call__ = call


@functools.lru_cache(maxsize=None)
def _jax(arch):
    cfg = j_get_smoke(arch).scaled(use_pallas=True)
    model = j_build_model(cfg)
    with stable_keys():
        return model, model.init_params(jax.random.key(0))


def _named(params):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _port(arch):
    """(model, weights Data on the CPU) carrying the JAX parameters."""
    cfg = get_smoke(arch)
    return build_model(cfg), interop.params_from_reference(_named(_jax(arch)[1]), cfg, "cpu")


def _cpu_app():
    return CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))


def _entries(layout):
    return [(e.name, e.shape, e.dtype, e.offset, e.nbytes) for e in layout.entries], \
        layout.total_bytes


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_and_state_layouts_match_reference(arch):
    jmodel, jparams = _jax(arch)
    model, weights = _port(arch)
    jw, _ = jlm.weights_data(jparams)
    tw, codec = tlm.weights_data(model.param_specs())
    assert _entries(tw.plan()) == _entries(jw.plan())
    assert codec.names == tuple(jw.names)
    js, jcodec = jlm.decode_state_data(jmodel, 3, MAX_LEN)
    ts, tcodec = tlm.decode_state_data(model, 3, MAX_LEN)
    assert _entries(ts.plan()) == _entries(js.plan())
    assert tcodec.names == jcodec.names
    # the carried-over weights are the JAX package's bytes at its offsets,
    # and so are those of the port's weights_data of the same parameter tree
    assert _entries(weights.layout) == _entries(jw.layout)
    want = np.asarray(jw.pack_host()).tobytes()
    assert weights.device_blob.numpy().tobytes() == want
    assert tlm.weights_data(codec.unflatten(weights.device_views()))[0].pack_host().tobytes() \
        == want


def _full_width_layouts_match(arch, n_params, f32_leaf="['u']"):
    """``arch`` at full width in bfloat16 (the leaves named ``f32_leaf``,
    rwkv6's ``u`` or a MoE router, in float32): the weights and a 4 x 2048
    decode state plan to the same entries and offsets in both packages,
    without allocating either."""
    jmodel = j_build_model(j_get_config(arch))
    shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.key(0)))
    jcodec = jlm.TreeCodec(shapes, prefix="w")
    jl = jarena.plan_layout((n, leaf.shape, leaf.dtype) for n, leaf in
                            zip(jcodec.names, jax.tree_util.tree_leaves(shapes)))
    model = build_model(get_config(arch))
    tw, _ = tlm.weights_data(model.param_specs())
    assert _entries(tw.plan()) == _entries(jl)
    assert {e.dtype for e in tw.layout.entries if not e.name.endswith(f32_leaf)} == {"bfloat16"}
    assert {e.dtype for e in tw.layout.entries if e.name.endswith(f32_leaf)} <= {"float32"}
    assert sum(int(np.prod(e.shape)) for e in tw.layout.entries) == n_params
    js, _ = jlm.decode_state_data(jmodel, 4, 2048)
    ts, _ = tlm.decode_state_data(model, 4, 2048)
    assert _entries(ts.plan()) == _entries(js.plan())


def test_full_width_bf16_layouts_match_reference():
    """qwen3-14b (14.77 B parameters)."""
    _full_width_layouts_match("qwen3-14b", 14_768_307_200)


def test_full_width_rwkv6_layouts_match_reference():
    """rwkv6-3b (3.10 B parameters, ``u`` float32)."""
    _full_width_layouts_match("rwkv6-3b", 3_099_694_080)


@pytest.mark.parametrize("arch,n_params", [("minitron-8b", 7_735_218_176),
                                           ("granite-moe-1b-a400m", 1_334_628_352),
                                           ("deepseek-v2-lite-16b", 15_706_484_224)])
def test_full_width_moe_mla_layouts_match_reference(arch, n_params):
    """minitron-8b (7.74 B), granite-moe-1b-a400m (1.33 B, 32 experts, the
    router float32) and deepseek-v2-lite-16b (15.71 B: MLA latents in the
    cache, 64 routed and 2 shared experts, the unstacked dense ``layer0``
    in the weights and the cache)."""
    _full_width_layouts_match(arch, n_params, f32_leaf="['router']")


@pytest.mark.parametrize("arch,n_params,f32_leaf", [
    ("zamba2-2.7b", 2_340_750_240, ("['A_log']", "['D']", "['dt_bias']")),
    ("internvl2-2b", 1_889_146_880, "['u']")], ids=["zamba2-2.7b", "internvl2-2b"])
def test_full_width_hybrid_vlm_layouts_match_reference(arch, n_params, f32_leaf):
    """zamba2-2.7b (2.34 B: the shared block once, 54 Mamba2 layers stacked
    (9, 6, ...), A_log, D and dt_bias float32; its 4 x 2048 decode state
    1.045 GB, 0.283 GB of it the float32 SSM states) and internvl2-2b (1.89
    B, vocab 92553, no multiple of 8)."""
    _full_width_layouts_match(arch, n_params, f32_leaf)
    if arch == "zamba2-2.7b":
        ts, _ = tlm.decode_state_data(build_model(get_config(arch)), 4, 2048)
        layout = ts.plan()
        assert round(layout.total_bytes / 1e9, 3) == 1.045
        ssm = next(e for e in layout.entries if e.name == "cache['ssm']['ssm']")
        assert ssm.shape == (9, 6, 4, 80, 64, 64) and round(ssm.nbytes / 1e9, 3) == 0.283


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch, rng):
    """Prefill a 12-token prompt, then 5 teacher-forced decode steps (both
    sides fed the JAX argmax): logits and every cache leaf agree (integer
    leaves, the cache positions, exactly)."""
    jmodel, jparams = _jax(arch)
    model, weights = _port(arch)
    params = tlm.TreeCodec(model.param_specs(), prefix="w").unflatten(weights.device_views())
    b, s = 2, 12
    tokens = rng.integers(0, model.cfg.vocab, (b, s)).astype(np.int32)
    jl, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(tokens),
                                         jmodel.init_cache(b, MAX_LEN))
    tl, tcache = model.prefill(params, torch.from_numpy(tokens), model.init_cache(b, MAX_LEN))
    step = jax.jit(jmodel.decode_step)
    for i in range(6):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        jleaves = _named(jcache)
        assert sorted(jleaves) == sorted(name for name, _ in tree_flatten(tcache))
        for name, leaf in tree_flatten(tcache):
            if leaf.dtype.is_floating_point:
                scale = (np.abs(jleaves[name]).max() if name in ("['wkv']", "['ssm']['ssm']")
                         else 1.0)
                np.testing.assert_allclose(leaf.numpy(), jleaves[name], rtol=1e-4,
                                           atol=1e-5 * scale, err_msg=name)
            else:
                np.testing.assert_array_equal(leaf.numpy(), jleaves[name], err_msg=name)
        if i == 5:
            break
        tok = np.array(jnp.argmax(jl, axis=-1).astype(jnp.int32))
        jl, jcache = step(jparams, jnp.asarray(tok), jnp.int32(s + i), jcache)
        tl, tcache = model.decode_step(params, torch.from_numpy(tok),
                                       torch.tensor(s + i, dtype=torch.int32), tcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_session_tokens_match_reference(arch, rng):
    jmodel, jparams = _jax(arch)
    model, weights = _port(arch)
    prompts = rng.integers(0, model.cfg.vocab, (2, 12)).astype(np.int32)
    jsess = jlm.DecodeSession(JApp().init(), jmodel, jparams, batch=2, max_len=MAX_LEN)
    tsess = tlm.DecodeSession(_cpu_app(), model, weights, batch=2, max_len=MAX_LEN)
    np.testing.assert_array_equal(tsess.prefill(prompts), jsess.prefill(prompts))
    for _ in range(5):
        np.testing.assert_array_equal(tsess.step(), jsess.step())
    assert tsess.state.coherence is Coherence.DEVICE_RESIDENT


@pytest.mark.parametrize("arch", SERVED_ALIKE)
def test_lmserver_matches_reference(arch):
    """6 prompts of mixed lengths through 2 slots: later requests are
    admitted into freed slots while others decode, and every request's
    tokens equal the JAX LMServer's."""
    jmodel, jparams = _jax(arch)
    model, weights = _port(arch)
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, model.cfg.vocab, n)) for n in (3, 12, 5, 12, 3, 5)]
    jsrv = JServer(jmodel, jparams, batch=2, max_len=MAX_LEN,
                   sampling=JSampling(max_new_tokens=5))
    tsrv = LMServer(model, weights, batch=2, max_len=MAX_LEN,
                    sampling=SamplingConfig(max_new_tokens=5), app=_cpu_app())
    for p in prompts:
        jsrv.submit(p)
        tsrv.submit(p)
    want = jsrv.run()
    assert tsrv.run() == want
    assert all(len(r) == 5 for r in want)
    assert (tsrv.steps, tsrv.admitted) == (jsrv.steps, jsrv.admitted)


def _state_stays_on_the_device(arch):
    """The decode state never grows a host mirror, never moves host to
    device and keeps its storage: every step writes the one arena in place,
    and only the prompts are uploaded."""
    model, weights = _port(arch)
    app = _cpu_app()
    srv = LMServer(model, weights, batch=3, max_len=MAX_LEN,
                   sampling=SamplingConfig(max_new_tokens=4), app=app)
    for n in (4, 6, 9, 4, 7):
        srv.submit(list(range(1, n + 1)))
    srv.step()                                   # the first admissions allocate the arenas
    arena = (srv.state.device_blob.data_ptr(), srv._row.device_blob.data_ptr())
    srv.run()
    assert (srv.state.device_blob.data_ptr(), srv._row.device_blob.data_ptr()) == arena
    assert srv.steps > 4 and srv.admitted == 5
    for data, h in ((srv.state, srv.state_h), (srv._row, srv._row_h)):
        assert data.coherence is Coherence.DEVICE_RESIDENT
        assert all(a.host is None for a in data)
        assert app.h2d_bytes.get(h, 0) == 0
    assert srv.decode_profile.phase_total("transfer") == 0.0
    # one prompt upload each, and the zero state's (the JAX LMServer's first splice uploads it)
    assert len(srv.prefill_profile.phases["transfer"]) == 5 + 1


def test_lmserver_state_stays_on_the_device():
    _state_stays_on_the_device("qwen3-14b")


def test_lmserver_rwkv6_state_stays_on_the_device():
    """The RWKV6 state (shift vectors and WKV state, written by the model
    and the kernel in place) too."""
    _state_stays_on_the_device("rwkv6-3b")


def test_splice_row_matches_reference_with_layers_unequal_to_slots(rng):
    """The admission splice with L = 2 layers and B = 3 slots, on every kind
    of state leaf, against the JAX package's ``_splice_row``."""
    shapes = {"k": ((2, 3, 2, 8, 4), (2, 1, 2, 8, 4)), "kpos": ((2, 3, 8), (2, 1, 8)),
              "token": ((3, 1), (1, 1)), "positions": ((3,), (1,))}
    for name, (full_shape, row_shape) in shapes.items():
        full = rng.standard_normal(full_shape).astype(np.float32)
        row = rng.standard_normal(row_shape).astype(np.float32)
        for slot in range(3):
            want = np.asarray(jlm._splice_row(jnp.asarray(full), jnp.asarray(row), slot))
            got = tlm._splice_row(torch.from_numpy(full.copy()), torch.from_numpy(row), slot)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} slot {slot}")


@pytest.mark.parametrize("full,row", [((32, 4, 2560), (32, 1, 2560)),
                                      ((32, 4, 40, 64, 64), (32, 1, 40, 64, 64))],
                         ids=["shift", "wkv"])
def test_splice_row_takes_the_slot_axis_of_rwkv6_leaves(full, row):
    """rwkv6-3b's full-width state leaves, (L, B, ...) with L = 32 and B = 4
    slots: the splice writes slot axis 1, as the JAX package's does."""
    base = np.zeros(full, np.float32)
    ones = np.ones(row, np.float32)
    for slot in (0, 3):
        want = np.asarray(jlm._splice_row(jnp.asarray(base), jnp.asarray(ones), slot))
        got = tlm._splice_row(torch.zeros(full), torch.ones(row), slot)
        assert got.numpy().sum(axis=tuple(i for i in range(len(full)) if i != 1)).nonzero()[0] \
            .tolist() == [slot]
        np.testing.assert_array_equal(got.numpy(), want)


class _CopyingRWKV6(RWKV6Model):
    """Returns its new cache as fresh tensors and leaves the given one as it
    was, as a JAX-style pure model would."""

    def _run_cached(self, params, tokens, cache):
        return super()._run_cached(params, tokens, tree_map(torch.clone, cache))


def test_decode_keeps_a_returned_cache_that_is_not_the_arena(rng):
    """A model that returns its cache instead of writing the arena views
    decodes the same tokens: prefill and step copy the returned leaves into
    the state arena."""
    model, weights = _port("rwkv6-3b")
    prompts = rng.integers(0, model.cfg.vocab, (2, 9)).astype(np.int32)
    sessions = [tlm.DecodeSession(_cpu_app(), m, weights, batch=2, max_len=MAX_LEN)
                for m in (model, _CopyingRWKV6(model.cfg))]
    np.testing.assert_array_equal(*(s.prefill(prompts) for s in sessions))
    for _ in range(4):
        np.testing.assert_array_equal(*(s.step() for s in sessions))
    assert torch.equal(sessions[0].state.device_blob, sessions[1].state.device_blob)


def test_decode_step_bound_out_of_place_leaves_its_input():
    """DecodeStep writes the state in place when bound in place; bound to
    another output it copies the state there first and leaves the input
    as it was, with the same result."""
    model, weights = _port("h2o-danube-1.8b")
    app = _cpu_app()
    sess = tlm.DecodeSession(app, model, weights, batch=2, max_len=MAX_LEN)
    sess.prefill(np.arange(20, dtype=np.int32).reshape(2, 10))
    before = sess.state.device_blob.clone()
    out, _ = tlm.decode_state_data(model, 2, MAX_LEN)
    out_h = app.addData(out, to_device=False)
    pipe = tlm.Pipeline(app) | tlm.DecodeStep(app, model, sess.wcodec, sess.ccodec,
                                              max_len=MAX_LEN).bind(
        infile=sess.state_h, outfile=out_h, weights=sess.weights_h)
    pipe.run(None, sync=False)
    assert torch.equal(sess.state.device_blob, before)
    sess.step()
    assert torch.equal(out.device_blob, sess.state.device_blob)


def test_prompt_limits_and_greedy_only():
    model, weights = _port("qwen2-7b")
    srv = LMServer(model, weights, batch=1, max_len=8, app=_cpu_app())
    with pytest.raises(PromptTooLongError, match="max_len=8"):
        srv.submit(list(range(8)))
    with pytest.raises(PromptTooLongError):
        srv.submit([])
    assert srv.submit(list(range(7))) == 0
    assert issubclass(PromptTooLongError, ValueError)
    for sampling in (SamplingConfig(temperature=0.7), SamplingConfig(top_k=5)):
        with pytest.raises(NotImplementedError, match="greedily"):
            LMServer(model, weights, batch=1, max_len=8, sampling=sampling, app=_cpu_app())


def test_lmserver_runs_on_the_card_unless_given_a_cpu_app(monkeypatch):
    model, weights = _port("qwen2-7b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoMatchingDeviceError):
        LMServer(model, weights, batch=1, max_len=8)


def test_unported_families_raise_naming_the_roadmap():
    """Every family of the JAX package is built (the VLM patch prefix
    and Zamba2 since the thirteenth slice), and an unknown family is
    refused; every family trains (``tests/test_torch_train.py``)."""
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro_torch.configs import ARCH_IDS

    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        assert type(build_model(get_smoke(arch))).__name__ == \
            type(j_build_model(j_get_smoke(arch))).__name__
    with pytest.raises(ValueError, match="unknown family"):
        build_model(get_smoke("qwen3-14b").scaled(family="diffusion"))
    vlm = build_model(get_smoke("internvl2-2b"))
    logits, _ = vlm.logits(vlm.init_params(torch.Generator().manual_seed(0)),
                           torch.zeros((1, 3), dtype=torch.int32),
                           prefix_embeds=torch.zeros((1, 2, 64)))
    assert logits.shape == (1, 5, 128) and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("variant", ["swiglu", "gelu", "relu2", "layernorm", "partial_rope",
                                     "tied"])
def test_layer_variants_match_reference(variant, rng):
    """The dense-path variants no SMOKE config above takes (the MLP kinds,
    layernorm, partial rotary, tied embeddings), each against the JAX
    package's layer function on the same numpy inputs (f32, 1e-5)."""
    from repro.models import layers as jL
    from repro_torch.models import layers as tL

    base = dict(mlp="gelu" if variant == "gelu" else "relu2" if variant == "relu2" else "swiglu",
                norm="layernorm" if variant == "layernorm" else "rmsnorm",
                rotary_pct=0.5 if variant == "partial_rope" else 1.0,
                tie_embeddings=variant == "tied")
    jcfg = j_get_smoke("qwen3-14b").scaled(**base)
    tcfg = get_smoke("qwen3-14b").scaled(**base)

    def arrays(specs):
        return {k: arrays(v) if isinstance(v, dict) else
                rng.standard_normal(v.shape).astype(np.float32) for k, v in specs.items()}

    def both(tree):
        return jax.tree_util.tree_map(jnp.asarray, tree), tree_map(torch.from_numpy, tree)

    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)
    if variant in ("swiglu", "gelu", "relu2"):
        jp, tp = both(arrays(tL.mlp_specs(tcfg)))
        want, got = jL.apply_mlp(jp, jnp.asarray(x), jcfg), tL.apply_mlp(tp, torch.from_numpy(x), tcfg)
    elif variant == "layernorm":
        jp, tp = both(arrays(tL.norm_specs(tcfg)))
        want, got = jL.apply_norm(jp, jnp.asarray(x), jcfg), tL.apply_norm(tp, torch.from_numpy(x), tcfg)
    elif variant == "partial_rope":
        q = rng.standard_normal((2, 4, 5, 16)).astype(np.float32)
        pos = np.tile(np.arange(3, 8, dtype=np.int32), (2, 1))
        want = jL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e4, 0.5)
        got = tL.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), 1e4, 0.5)
    else:
        jp, tp = both(arrays(tL.embed_specs(tcfg)))
        assert set(tp) == {"embedding"}
        want = jL.logits_from_hidden(jp, jnp.asarray(x), jcfg)
        got = tL.logits_from_hidden(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["groups_of_5", "groups_of_1", "sliding_window"])
def test_grouped_decode_attention_matches_reference(case, dtype, rng):
    """``attention_decode`` with the query heads grouped by KV head (no
    copy of the cache per query head) against the JAX function, which
    repeats K and V: G = H / Hkv = 5 (qwen3-14b's 40 / 8 at SMOKE widths),
    G = 1, and h2o-danube's sliding window (8) at G = 2, over a cache with
    entries at several positions, empty (kpos = -1) slots and keys outside
    the window.  f32 at rtol/atol 1e-5; bf16 at 2e-2 (both sides round
    the projections and the output to bf16, each in its own order)."""
    from repro.models import layers as jL
    from repro_torch.models import layers as tL

    arch, heads = {"groups_of_5": ("qwen3-14b", dict(n_heads=10, n_kv_heads=2)),
                   "groups_of_1": ("qwen3-14b", dict(n_heads=4, n_kv_heads=4)),
                   "sliding_window": ("h2o-danube-1.8b", {})}[case]
    over = dict(heads, param_dtype=dtype, dtype=dtype)
    jcfg, tcfg = j_get_smoke(arch).scaled(**over), get_smoke(arch).scaled(**over)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)

    def arrays(specs):
        return {k: arrays(v) if isinstance(v, dict) else
                (rng.standard_normal(v.shape) / np.sqrt(v.shape[0])).astype(np.float32)
                for k, v in specs.items()}

    p = arrays(tL.attention_specs(tcfg))
    b, hkv, dh, c, pos = 2, tcfg.n_kv_heads, tcfg.head_dim, 12, 9
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, c, dh)).astype(np.float32) for _ in range(2))
    kpos = np.array([[-1, 3, 0, 7, -1, 5, 1, 8, 2, -1, 6, 4],
                     [6, -1, -1, 2, 8, 0, 4, -1, 1, 3, 7, 5]], np.int32)
    jcache = {"k": jnp.asarray(k, jdt), "v": jnp.asarray(v, jdt), "kpos": jnp.asarray(kpos)}
    tcache = {"k": torch.from_numpy(k).to(tdt), "v": torch.from_numpy(v).to(tdt),
              "kpos": torch.from_numpy(kpos.copy())}
    want, jnew = jL.attention_decode(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), p),
                                     jnp.asarray(x, jdt), jcfg, jnp.int32(pos), jcache)
    got, tnew = tL.attention_decode(tree_map(lambda a: torch.from_numpy(a).to(tdt), p),
                                    torch.from_numpy(x).to(tdt), tcfg,
                                    torch.tensor(pos, dtype=torch.int32), tcache)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(tnew[name].float().numpy(), np.asarray(jnew[name], np.float32),
                                   err_msg=name, **tol)
    np.testing.assert_array_equal(tnew["kpos"].numpy(), np.asarray(jnew["kpos"]))
