"""The port's Mamba2 layer and Zamba2 hybrid (zamba2-2.7b SMOKE) against the
JAX package's, the admission splice's slot axis, short prompts and the
launch scripts' ``--arch zamba2-2.7b``.  The model-level layouts, logits
and ``DecodeSession`` tokens of zamba2-2.7b are also in
``tests/test_torch_lm.py``'s ``ARCHS``.

Two faults of the frozen reference are recorded here, not copied:

* its ``_splice_row`` guesses the slot axis (0, else 1), and Zamba2's SSM
  leaves are (n_super, per_super, B, ...), so its ``LMServer(batch > 1)``
  writes every admitted zamba2 row into slot 0;
* its ``Zamba2Model.prefill`` keeps ``xbc[:, -(ssm_conv - 1):]`` as the
  conv window, so a prompt shorter than ``ssm_conv - 1`` leaves a short
  one.

Tolerances: float32 throughout, rtol/atol 1e-5 (two frameworks summing in
other orders), except the whole model's cache leaves, at rtol 1e-5 and
atol 1e-5 x max |leaf|: the SSM state sums decayed products over the
prompt (up to about 10 here), and the JAX package against itself, with its
Pallas attention and without, differs by 3.1e-5 on it after a 12-token
prefill.  Cache positions, greedy tokens and spliced leaves exactly.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import process as jprocess
from repro.models import mamba2 as jm2
from repro.processes import lm as jlm
from repro.serve import LMServer as JServer, SamplingConfig as JSampling
from repro_torch.configs import get_smoke
from repro_torch.core.arena import torch_dtype
from repro_torch.models import Zamba2Model, build_model, mamba2 as tm2
from repro_torch.models.common import tree_flatten, tree_map
from repro_torch.processes import lm as tlm
from repro_torch.serve import LMServer, SamplingConfig

import test_torch_lm as T
from test_torch_moe_mla import _arrays, _both

ROOT = Path(__file__).resolve().parents[1]
ZAMBA = "zamba2-2.7b"
TOL = dict(rtol=1e-5, atol=1e-5)
#: the eight families' configs served before this one: their state leaves
#: keep the reference's slot axis
EARLIER = T.ARCHS[:7] + ["whisper-large-v3"]


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=name, **TOL)


def _cfgs():
    return j_get_smoke(ZAMBA), get_smoke(ZAMBA)


def _params():
    """The JAX SMOKE model and parameters, the port's model and the same
    parameters as a tree of CPU tensors."""
    jmodel, jparams = T._jax(ZAMBA)
    model, weights = T._port(ZAMBA)
    return jmodel, jparams, model, tlm.TreeCodec(model.param_specs(), prefix="w").unflatten(
        weights.device_views())


def _assert_cache_matches(tcache, jcache, label=""):
    jleaves = T._named(jcache)
    assert sorted(jleaves) == sorted(n for n, _ in tree_flatten(tcache))
    for name, leaf in tree_flatten(tcache):
        assert tuple(leaf.shape) == jleaves[name].shape, f"{label} {name}"
        if leaf.dtype.is_floating_point:
            np.testing.assert_allclose(leaf.numpy(), jleaves[name], rtol=1e-5,
                                       atol=1e-5 * max(1.0, np.abs(jleaves[name]).max()),
                                       err_msg=f"{label} {name}")
        else:
            np.testing.assert_array_equal(leaf.numpy(), jleaves[name], err_msg=f"{label} {name}")


# ---------------------------------------------------------------------------
# Mamba2: the SSD and the layer
# ---------------------------------------------------------------------------

def test_segsum_matches_reference(rng):
    x = rng.standard_normal((2, 3, 7)).astype(np.float32)
    want = np.asarray(jm2._segsum(jnp.asarray(x)))
    got = tm2._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    _close(np.where(np.isinf(got), 0, got), np.where(np.isinf(want), 0, want))


def _ssd_inputs(rng, s, with_h0, b=2, h=3, p=4, n=5):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_h0 else None
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "h0"])
@pytest.mark.parametrize("s", [16, 13, 5], ids=["chunk_multiple", "ragged", "shorter"])
def test_ssd_chunked_matches_reference(s, with_h0, rng):
    """Chunk 8: two whole chunks, a ragged last chunk (time zero-padded
    with dt = 0) and a sequence shorter than a chunk (q = s); from a zero
    state and from ``h0``."""
    args = _ssd_inputs(rng, s, with_h0)
    jy, jh = jm2._ssd_chunked(*(None if a is None else jnp.asarray(a) for a in args[:5]), 8,
                              None if args[5] is None else jnp.asarray(args[5]))
    ty, th = tm2._ssd_chunked(*(torch.from_numpy(a) for a in args[:5]), 8,
                              None if args[5] is None else torch.from_numpy(args[5]))
    assert tuple(ty.shape) == jy.shape and th.dtype == torch.float32
    _close(ty.numpy(), jy, "y")
    _close(th.numpy(), jh, "final state")


def _layer(rng):
    jcfg, tcfg = _cfgs()
    p = _arrays(tm2.mamba2_specs(tcfg), rng)
    p["A_log"] = (rng.standard_normal(p["A_log"].shape) * 0.5).astype(np.float32)
    p["D"] = (1 + rng.standard_normal(p["D"].shape) * 0.1).astype(np.float32)
    return jcfg, tcfg, *_both(p)


@pytest.mark.parametrize("s", [11, 16])
def test_mamba2_forward_matches_reference(s, rng):
    jcfg, tcfg, jp, tp = _layer(rng)
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    _close(tm2.mamba2_forward(tp, torch.from_numpy(x), tcfg).numpy(),
           jm2.mamba2_forward(jp, jnp.asarray(x), jcfg))


def test_mamba2_step_matches_reference_and_writes_the_state_in_place(rng):
    jcfg, tcfg, jp, tp = _layer(rng)
    spec = tm2.mamba2_state_specs(tcfg, 2)
    state = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in spec.items()}
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    want, jstate = jm2.mamba2_step(jp, jnp.asarray(x), jcfg,
                                   {k: jnp.asarray(v) for k, v in state.items()})
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    storage = {k: v.data_ptr() for k, v in tstate.items()}
    got, new = tm2.mamba2_step(tp, torch.from_numpy(x), tcfg, tstate)
    _close(got.numpy(), want, "out")
    assert new is tstate and {k: v.data_ptr() for k, v in new.items()} == storage
    for k in state:
        _close(new[k].numpy(), jstate[k], k)
    np.testing.assert_array_equal(new["conv"][:, :-1].numpy(), state["conv"][:, 1:])


@pytest.mark.parametrize("s", [1, 2, 3, 13])
def test_chunked_prefill_state_equals_stepping(s, rng):
    """``mamba2_scan`` over s tokens (chunk 8) leaves the conv window and
    SSM state, and gives the outputs, that s single-token steps from a zero
    state give; for s < ssm_conv - 1 the window keeps the zero history in
    front of the prompt."""
    _, tcfg, _, tp = _layer(rng)
    x = torch.from_numpy(rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32))
    out, conv, ssm = tm2.mamba2_scan(tp, x, tcfg)
    state = tm2.init_mamba2_state(tcfg, 2)
    steps = [tm2.mamba2_step(tp, x[:, t:t + 1], tcfg, state)[0] for t in range(s)]
    _close(out.numpy(), torch.cat(steps, dim=1).numpy(), "outputs")
    assert tuple(conv.shape) == tuple(state["conv"].shape)
    _close(conv.numpy(), state["conv"].numpy(), "conv")   # one projection a token or all
    _close(ssm.numpy(), state["ssm"].numpy(), "ssm")


# ---------------------------------------------------------------------------
# Zamba2: parameters, cache, prefill and decode
# ---------------------------------------------------------------------------

def test_zamba2_builds_with_the_reference_structure():
    jcfg, tcfg = _cfgs()
    model = build_model(tcfg)
    assert isinstance(model, Zamba2Model)
    assert (model.n_super, model.per_super) == (2, 2)
    assert model.kernel_names == ("rmsnorm", "flash_attention")
    specs = dict(tree_flatten(model.param_specs()))
    assert specs["['mamba_layers']['mamba']['in_proj']"].shape == (2, 2, 64, 2 * 128 + 32 + 16)
    assert {str(s.dtype) for n, s in specs.items()
            if n.endswith(("['A_log']", "['D']", "['dt_bias']"))} == {"float32"}
    with pytest.raises(ValueError, match="attn_every"):
        build_model(tcfg.scaled(n_layers=3))


@pytest.mark.parametrize("stacked", [True, False], ids=["zamba2", "one_layer"])
def test_init_follows_the_reference_roles(stacked):
    """Random init by role, as the reference's ``init_mamba2``: A_log,
    dt_bias and conv_b 0, D and the norm scales 1, the conv taps with
    fan-in ssm_conv; in Zamba2's (n_super, per_super) stack and for one
    layer (``init_mamba2``)."""
    gen = torch.Generator().manual_seed(0)
    if stacked:
        p = build_model(get_smoke(ZAMBA)).init_params(gen)
        m, ones = p["mamba_layers"]["mamba"], [p["mamba_layers"]["ln"]["scale"]]
    else:
        m, ones = tm2.init_mamba2(gen, get_smoke(ZAMBA)), []
    for name in ("A_log", "dt_bias", "conv_b"):
        assert not m[name].any(), name
    for t in [m["D"], m["norm_scale"]] + ones:
        assert bool((t == 1).all())
    assert 0.3 < float(m["conv_w"].std()) < 0.7            # N(0, 4^-1/2)
    assert 0.08 < float(m["in_proj"].std()) < 0.17         # N(0, 64^-1/2)


@pytest.mark.parametrize("s", [12, 20])
def test_zamba2_prefill_and_decode_match_reference(s, rng):
    """Prefill an s-token prompt (chunk 8: 20 takes a ragged last chunk),
    then 4 decode steps fed the JAX argmax: logits and every cache leaf
    (K/V, kpos, conv windows, SSM states) at 1e-5."""
    jmodel, jparams, model, params = _params()
    tokens = rng.integers(0, model.cfg.vocab, (2, s)).astype(np.int32)
    jl, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(tokens),
                                         jmodel.init_cache(2, T.MAX_LEN))
    tcache = model.init_cache(2, T.MAX_LEN)
    storage = {n: t.data_ptr() for n, t in tree_flatten(tcache)}
    tl, tcache = model.prefill(params, torch.from_numpy(tokens), tcache)
    step = jax.jit(jmodel.decode_step)
    for i in range(5):
        _close(tl.numpy(), jl, f"logits {i}")
        _assert_cache_matches(tcache, jcache, f"step {i}")
        if i == 4:
            break
        tok = np.array(jnp.argmax(jl, axis=-1).astype(jnp.int32))
        jl, jcache = step(jparams, jnp.asarray(tok), jnp.int32(s + i), jcache)
        tl, tcache = model.decode_step(params, torch.from_numpy(tok),
                                       torch.tensor(s + i, dtype=torch.int32), tcache)
    assert {n: t.data_ptr() for n, t in tree_flatten(tcache)} == storage


@pytest.mark.parametrize("s", [1, 2, 3])
def test_short_prompt_prefill_equals_reference_stepping(s, rng):
    """A 1-, 2- or 3-token prompt: the port's prefill, then 4 decode steps,
    equals the reference's ``decode_step`` run token by token from
    ``init_cache`` (logits and every cache leaf, at each of the 5 points):
    the conv window keeps the zero history in front of the prompt."""
    jmodel, jparams, model, params = _params()
    tokens = rng.integers(0, model.cfg.vocab, (2, s)).astype(np.int32)
    step = jax.jit(jmodel.decode_step)
    jcache = jmodel.init_cache(2, T.MAX_LEN)
    for t in range(s):
        jl, jcache = step(jparams, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t), jcache)
    tl, tcache = model.prefill(params, torch.from_numpy(tokens), model.init_cache(2, T.MAX_LEN))
    for i in range(5):
        _close(tl.numpy(), jl, f"logits {i}")
        _assert_cache_matches(tcache, jcache, f"point {i}")
        if i == 4:
            break
        tok = np.array(jnp.argmax(jl, axis=-1).astype(jnp.int32))
        jl, jcache = step(jparams, jnp.asarray(tok), jnp.int32(s + i), jcache)
        tl, tcache = model.decode_step(params, torch.from_numpy(tok), s + i, tcache)


@pytest.mark.parametrize("s", [1, 2])
def test_reference_prefill_leaves_a_short_conv_window(s, rng):
    """The reference fault the port does not copy: its prefill keeps
    ``xbc[:, -(ssm_conv - 1):]``, s rows for an s-token prompt."""
    jmodel, jparams = T._jax(ZAMBA)
    tokens = jnp.asarray(rng.integers(0, 128, (1, s)).astype(np.int32))
    _, jcache = jmodel.prefill(jparams, tokens, jmodel.init_cache(1, T.MAX_LEN))
    want = jmodel.init_cache(1, T.MAX_LEN)["ssm"]["conv"].shape
    assert want == (2, 2, 1, 3, 160) and jcache["ssm"]["conv"].shape == (2, 2, 1, s, 160)


def test_reset_cache_empties_every_leaf():
    model = build_model(get_smoke(ZAMBA))
    cache = model.cache_specs(2, 8)
    cache = tree_map(lambda sp: torch.full(sp.shape, 7, dtype=torch_dtype(sp.dtype)), cache)
    model.reset_cache(cache)
    for name, t in tree_flatten(cache):
        assert bool((t == (-1 if name.endswith("['kpos']") else 0)).all()), name


# ---------------------------------------------------------------------------
# The admission splice
# ---------------------------------------------------------------------------

def _state_specs(arch, batch):
    model = build_model(get_smoke(arch))
    enc = 8 if model.cfg.family == "encdec" else None
    return tlm.decode_state_data(model, batch, T.MAX_LEN, enc)[0].specs()


@pytest.mark.parametrize("arch", EARLIER)
def test_splice_row_matches_reference_on_every_earlier_leaf(arch, rng):
    """On every decode-state leaf of the eight families served before
    (3 slots and a 1-slot row; then 1 slot, the whole-row case), the
    differing-axis splice writes what the reference's ``_splice_row``
    writes, slot by slot."""
    for batch in (3, 1):
        full_specs, row_specs = _state_specs(arch, batch), _state_specs(arch, 1)
        assert list(full_specs) == list(row_specs)
        for name, fs in full_specs.items():
            full = rng.standard_normal(fs.shape).astype(np.float32)
            row = rng.standard_normal(row_specs[name].shape).astype(np.float32)
            for slot in range(batch):
                want = np.asarray(jlm._splice_row(jnp.asarray(full), jnp.asarray(row), slot))
                got = tlm._splice_row(torch.from_numpy(full.copy()), torch.from_numpy(row), slot)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} slot {slot}")


@pytest.mark.parametrize("leaf", ["['ssm']['conv']", "['ssm']['ssm']", "['kv']['k']",
                                  "['kv']['kpos']"])
def test_splice_row_writes_the_slot_axis_of_zamba2_leaves(leaf):
    """Zamba2's Mamba2 state, (n_super, per_super, B, ...), takes slot k on
    axis 2, its shared block's K/V, (n_super, B, ...), on axis 1; a row of
    the wrong shape raises."""
    full, row = _state_specs(ZAMBA, 4)[f"cache{leaf}"], _state_specs(ZAMBA, 1)[f"cache{leaf}"]
    axis = 2 if leaf.startswith("['ssm']") else 1
    for slot in (0, 3):
        got = tlm._splice_row(torch.zeros(full.shape), torch.ones(row.shape), slot)
        other = tuple(i for i in range(len(full.shape)) if i != axis)
        assert got.sum(dim=other).nonzero().flatten().tolist() == [slot]
        assert float(got.sum()) == np.prod(row.shape)
    with pytest.raises(ValueError, match="does not fit"):
        tlm._splice_row(torch.zeros(full.shape),
                        torch.ones(row.shape[:-1] + (full.shape[-1] - 1,)), 0)


def _differing_axis_splice(full, row, slot):
    """The port's rule in jnp, for the reference server (inside a test only)."""
    if full.shape == row.shape:
        return row
    axis = next(i for i, (a, b) in enumerate(zip(full.shape, row.shape)) if a != b)
    return jax.lax.dynamic_update_slice_in_dim(full, row, slot, axis=axis)


def _served(prompts, batch, *, jax_server=False, patched=False, monkeypatch=None):
    """Tokens of ``prompts`` (5 new tokens each) through ``batch`` slots of
    the port's ``LMServer``, or of the JAX package's (with a fresh compile
    cache, so no executable of another test's splice is reused)."""
    if jax_server:
        jmodel, jparams = T._jax(ZAMBA)
        monkeypatch.setattr(jprocess, "_COMPILE_CACHE", {})
        if patched:
            monkeypatch.setattr(jlm, "_splice_row", _differing_axis_splice)
        srv = JServer(jmodel, jparams, batch=batch, max_len=T.MAX_LEN,
                      sampling=JSampling(max_new_tokens=5))
    else:
        model, weights = T._port(ZAMBA)
        srv = LMServer(model, weights, batch=batch, max_len=T.MAX_LEN,
                       sampling=SamplingConfig(max_new_tokens=5), app=T._cpu_app())
    for p in prompts:
        srv.submit(p)
    return srv.run()


def _prompts(lengths, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n).tolist() for n in lengths]


def test_zamba2_lmserver_returns_each_requests_own_tokens(monkeypatch):
    """Two 7-token prompts admitted together into 2 slots: each gets the
    tokens the JAX ``LMServer(batch=1)`` gives it alone (equal lengths, so
    both rows decode at their own positions)."""
    prompts = _prompts((7, 7))
    want = _served(prompts, 1, jax_server=True, monkeypatch=monkeypatch)
    assert _served(prompts, 2) == want
    assert _served(prompts, 1) == want


def test_reference_lmserver_splices_zamba2_rows_into_slot_0(monkeypatch):
    """The reference fault the port does not copy: the unpatched JAX
    ``LMServer(batch=2)`` does not return each request's own tokens."""
    prompts = _prompts((7, 7))
    alone = _served(prompts, 1, jax_server=True, monkeypatch=monkeypatch)
    assert _served(prompts, 2, jax_server=True, monkeypatch=monkeypatch) != alone


def test_zamba2_lmserver_matches_patched_reference_at_batch_4(monkeypatch):
    """7 prompts of mixed lengths through 4 slots, later ones admitted into
    freed slots: the port's tokens equal the JAX ``LMServer``'s with its
    ``_splice_row`` patched (inside this test) to the differing-axis rule."""
    prompts = _prompts((3, 12, 5, 12, 3, 5, 9), seed=7)
    want = _served(prompts, 4, jax_server=True, patched=True, monkeypatch=monkeypatch)
    assert _served(prompts, 4) == want
    assert all(len(r) == 5 for r in want)


def test_zamba2_row_cache_admits_twice(monkeypatch):
    """One slot, so the second request is prefilled through the row cache
    the first one left: its prefill starts from a reset state, and both
    requests get the tokens the JAX ``LMServer(batch=1)`` gives, the second
    also what a fresh server gives it alone."""
    prompts = _prompts((6, 9), seed=3)
    got = _served(prompts, 1)
    assert got == _served(prompts, 1, jax_server=True, monkeypatch=monkeypatch)
    assert got[1] == _served(prompts[1:], 1)[0]


# ---------------------------------------------------------------------------
# The launch scripts' --arch
# ---------------------------------------------------------------------------

def test_serve_lm_example_serves_zamba2_on_a_cpu_app(capsys):
    from repro_torch.launch import serve_lm

    out = serve_lm.main(["--cpu", "--arch", ZAMBA])
    assert [len(r) for r in out[ZAMBA]] == [16] * 10
    text = capsys.readouterr().out
    assert f"[{ZAMBA}] served 10 requests" in text
    assert "decode-side host2device on the cache edge: 0.000000s" in text


def test_lm_step_profile_takes_zamba2_and_needs_the_card():
    """``--arch zamba2-2.7b --layers 6`` (one superblock) parses, then
    refuses to run without a card; a depth that is no multiple of
    ``attn_every`` is refused by the parser."""
    script = ROOT / "src/repro_torch/launch/lm_step_profile.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(script), "--arch", ZAMBA, "--layers", "6"],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0 and "no CUDA card" in r.stderr, r.stderr[-2000:]
    r = subprocess.run([sys.executable, str(script), "--arch", ZAMBA, "--layers", "4"],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 2 and "multiple of attn_every" in r.stderr, r.stderr[-2000:]
