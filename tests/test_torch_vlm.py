"""The port's VLM path (internvl2-2b SMOKE: the InternLM2-style decoder with
the vision front end stubbed, its patch embeddings given by the caller)
against the JAX package's ``DecoderLM.prefill(prefix_embeds=)``, plus the
text-only serving and the launch scripts' ``--arch internvl2-2b``.  The
model-level layouts, logits, ``DecodeSession`` and ``LMServer`` tokens of
internvl2-2b are in ``tests/test_torch_lm.py``'s ``ARCHS``.

Tolerances: float32 at rtol/atol 1e-5 (two frameworks summing in other
orders), cache positions and greedy tokens exactly.
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
from repro.models import build_model as j_build_model
from repro.processes import lm as jlm
from repro.core.app import CLapp as JApp
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.models import DecoderLM, build_model
from repro_torch.models.common import tree_flatten
from repro_torch.processes import lm as tlm
from repro_torch.serve import LMServer, SamplingConfig

import test_torch_lm as T

ROOT = Path(__file__).resolve().parents[1]
VLM = "internvl2-2b"
TOL = dict(rtol=1e-5, atol=1e-5)


def _models(dtype="float32", **over):
    """(JAX model, JAX parameters, port model, the same parameters as a
    tree of CPU tensors) of internvl2-2b SMOKE in ``dtype``."""
    jcfg = j_get_smoke(VLM).scaled(use_pallas=True, param_dtype=dtype, dtype=dtype, **over)
    jmodel = j_build_model(jcfg)
    with T.stable_keys():
        jparams = jmodel.init_params(jax.random.key(0))
    cfg = get_smoke(VLM).scaled(param_dtype=dtype, dtype=dtype, **over)
    model = build_model(cfg)
    weights = interop.params_from_reference(T._named(jparams), cfg, "cpu")
    params = tlm.TreeCodec(model.param_specs(), prefix="w").unflatten(weights.device_views())
    return jmodel, jparams, model, params


def test_vlm_builds_the_decoder():
    model = build_model(get_smoke(VLM))
    assert isinstance(model, DecoderLM) and model.cfg.n_patches == 4
    assert model.kernel_names == ("rmsnorm", "flash_attention")


@pytest.mark.parametrize("p,s", [(4, 9), (4, 1), (12, 7)])
def test_prefix_prefill_and_decode_match_reference(p, s, rng):
    """A (B, P, D) f32 patch prefix in front of an S-token prompt: the
    prefix is cast to the activation dtype, positions run over P + S and
    the cache holds P + S entries; then 4 decode steps at P + S + i, fed
    the JAX argmax.  Logits and every cache leaf against the JAX package
    (12 patches: the SMOKE config's 4 is no limit)."""
    jmodel, jparams, model, params = _models()
    b = 2
    tokens = rng.integers(0, model.cfg.vocab, (b, s)).astype(np.int32)
    prefix = rng.standard_normal((b, p, model.cfg.d_model)).astype(np.float32)
    jl, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(tokens),
                                         jmodel.init_cache(b, T.MAX_LEN), jnp.asarray(prefix))
    tl, tcache = model.prefill(params, torch.from_numpy(tokens), model.init_cache(b, T.MAX_LEN),
                               prefix_embeds=torch.from_numpy(prefix))
    kpos = tcache["scan"]["kpos"].numpy()
    assert (kpos[..., :p + s] == np.arange(p + s)).all() and (kpos[..., p + s:] == -1).all()
    step = jax.jit(jmodel.decode_step)
    for i in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"logits {i}", **TOL)
        jleaves = T._named(jcache)
        for name, leaf in tree_flatten(tcache):
            if leaf.dtype.is_floating_point:
                np.testing.assert_allclose(leaf.numpy(), jleaves[name], err_msg=f"{i} {name}",
                                           **TOL)
            else:
                np.testing.assert_array_equal(leaf.numpy(), jleaves[name], err_msg=name)
        if i == 4:
            break
        tok = np.array(jnp.argmax(jl, axis=-1).astype(jnp.int32))
        jl, jcache = step(jparams, jnp.asarray(tok), jnp.int32(p + s + i), jcache)
        tl, tcache = model.decode_step(params, torch.from_numpy(tok),
                                       torch.tensor(p + s + i, dtype=torch.int32), tcache)


def test_a_prefix_of_token_embeddings_is_the_longer_prompt(rng):
    """The prefix takes the place of embedded tokens: prefixing the
    embeddings of the first 5 tokens gives the full prompt's logits and
    cache."""
    _, _, model, params = _models()
    tokens = torch.from_numpy(rng.integers(0, model.cfg.vocab, (1, 11)).astype(np.int32))
    want, wcache = model.prefill(params, tokens, model.init_cache(1, T.MAX_LEN))
    emb = params["embed"]["embedding"][tokens[:, :5].long()]
    got, gcache = model.prefill(params, tokens[:, 5:], model.init_cache(1, T.MAX_LEN),
                                prefix_embeds=emb)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for (name, a), (_, b) in zip(tree_flatten(gcache), tree_flatten(wcache)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=name)


def test_prefix_is_cast_to_the_activation_dtype(rng):
    """In bfloat16 an f32 prefix goes in as its bf16 rounding, as the
    reference's ``prefix_embeds.astype(cfg.adtype)``."""
    _, _, model, params = _models("bfloat16")
    tokens = torch.from_numpy(rng.integers(0, model.cfg.vocab, (1, 6)).astype(np.int32))
    prefix = torch.from_numpy(rng.standard_normal((1, 4, 64)).astype(np.float32))
    runs = [model.prefill(params, tokens, model.init_cache(1, T.MAX_LEN), prefix_embeds=pre)
            for pre in (prefix, prefix.to(torch.bfloat16))]
    assert runs[0][0].dtype == torch.float32 and torch.equal(runs[0][0], runs[1][0])
    for (name, a), (_, b) in zip(tree_flatten(runs[0][1]), tree_flatten(runs[1][1])):
        assert a.dtype in (torch.bfloat16, torch.int32) and torch.equal(a, b), name


def test_odd_vocab_logits_and_tokens_match_reference(rng):
    """internvl2-2b's vocabulary, 92553, is odd: at SMOKE widths with an odd
    vocabulary (131) the logits and the greedy tokens of a 2-slot
    ``DecodeSession`` equal the JAX package's."""
    jmodel, jparams, model, params = _models(vocab=131)
    prompts = rng.integers(0, 131, (2, 12)).astype(np.int32)
    jsess = jlm.DecodeSession(JApp().init(), jmodel, jparams, batch=2, max_len=T.MAX_LEN)
    tsess = tlm.DecodeSession(T._cpu_app(), model, params, batch=2, max_len=T.MAX_LEN)
    np.testing.assert_array_equal(tsess.prefill(prompts), jsess.prefill(prompts))
    for _ in range(5):
        np.testing.assert_array_equal(tsess.step(), jsess.step())
    tl, _ = model.prefill(params, torch.from_numpy(prompts), model.init_cache(2, T.MAX_LEN))
    jl, _ = jmodel.prefill(jparams, jnp.asarray(prompts), jmodel.init_cache(2, T.MAX_LEN))
    assert tl.shape == (2, 1, 131)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_lmserver_serves_internvl2_text_only():
    """As the JAX ``LMServer``: prompts only; a request with frames (or
    patches) is refused."""
    model, weights = T._port(VLM)
    srv = LMServer(model, weights, batch=1, max_len=T.MAX_LEN,
                   sampling=SamplingConfig(max_new_tokens=3), app=T._cpu_app())
    with pytest.raises(ValueError, match="take no frames"):
        srv.submit([1, 2, 3], frames=np.zeros((4, 64), np.float32))
    srv.submit([1, 2, 3])
    assert [len(r) for r in srv.run()] == [3]


# ---------------------------------------------------------------------------
# The launch scripts' --arch
# ---------------------------------------------------------------------------

def test_serve_lm_example_serves_internvl2_on_a_cpu_app(capsys):
    from repro_torch.launch import serve_lm

    out = serve_lm.main(["--cpu", "--arch", VLM])
    assert [len(r) for r in out[VLM]] == [16] * 10
    text = capsys.readouterr().out
    assert f"[{VLM}] served 10 requests" in text
    assert "decode-side host2device on the cache edge: 0.000000s" in text


def test_lm_step_profile_takes_internvl2_and_needs_the_card():
    script = ROOT / "src/repro_torch/launch/lm_step_profile.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(script), "--arch", VLM, "--layers", "2"],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0 and "no CUDA card" in r.stderr, r.stderr[-2000:]
