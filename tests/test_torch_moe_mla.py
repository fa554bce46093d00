"""The port's MoE and MLA layers (granite-moe-1b-a400m, deepseek-v2-lite-16b)
against the JAX package's, layer by layer, plus what the decode-state
plumbing does with deepseek's unstacked ``layer0`` cache and the two
launch scripts' ``--arch``.  The model-level parity (layouts, logits,
``DecodeSession`` and ``LMServer`` tokens) of the three configs of this
slice is in ``tests/test_torch_lm.py``.

Tolerances: float32 throughout; layer outputs at rtol/atol 1e-5 (two
frameworks summing in other orders), the MoE's count of dropped choices,
every cache position and greedy tokens exactly.
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
from repro.kernels import ref as jref
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.processes import lm as jlm
from repro.serve import LMServer as JServer, SamplingConfig as JSampling
from repro_torch.configs import get_smoke
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model, mla as tmla, moe as tmoe
from repro_torch.models.common import alloc_tree, tree_flatten, tree_map
from repro_torch.processes import lm as tlm
from repro_torch.serve import LMServer, SamplingConfig

import test_torch_lm as T

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
GRANITE, DEEPSEEK = "granite-moe-1b-a400m", "deepseek-v2-lite-16b"


def _arrays(specs, rng):
    """Random f32 numpy leaves for a tree of specs, projections scaled by
    their fan-in."""
    return {k: _arrays(v, rng) if isinstance(v, dict) else
            (rng.standard_normal(v.shape) / np.sqrt(v.shape[0])).astype(np.float32)
            for k, v in specs.items()}


def _both(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree), tree_map(torch.from_numpy, tree)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = {
    # tests/test_models.py's two dispatch cases: ample capacity (nothing
    # dropped) and tiny capacity (most choices dropped)
    "ample": (dict(d_model=32, d_ff=48, n_experts=4, top_k=2, capacity_factor=4.0), (3, 8)),
    "tiny": (dict(d_model=16, d_ff=32, n_experts=2, top_k=2, capacity_factor=0.1), (1, 64)),
    # deepseek's form at SMOKE widths: a shared expert beside the routed ones
    "shared": (dict(), (2, 11)),
    # one decode token a row: capacity 8, every expert multiplied
    "decode": (dict(), (4, 1)),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_reference(case, rng):
    """``apply_moe`` (router softmax in f32, top-k and renormalised gates,
    row-local slots in (token, k) order, overflow to the dump slot, SwiGLU
    experts, gather-combine, shared expert) and its metrics against the
    JAX function on the same numpy weights and inputs.  The same number of
    choices is dropped; the ample case also matches a dense loop over the
    experts (tests/test_models.py's check)."""
    over, (b, s) = MOE_CASES[case]
    jcfg, tcfg = j_get_smoke(DEEPSEEK).scaled(**over), get_smoke(DEEPSEEK).scaled(**over)
    if case in ("ample", "tiny"):
        jcfg, tcfg = jcfg.scaled(n_shared_experts=0), tcfg.scaled(n_shared_experts=0)
    p = _arrays(tmoe.moe_specs(tcfg), rng)
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    jp, tp = _both(p)
    want, jaux = jax.jit(lambda pp, xx: jmoe.apply_moe(pp, xx, jcfg))(jp, jnp.asarray(x))
    got, taux = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the same choices dropped: equal counts (the JAX mean multiplies by a
    # rounded 1 / n, so its rate sits an ulp off the count's: -3e-8 for none)
    n = b * s * tcfg.top_k
    assert round(float(taux["moe_drop_rate"]) * n) == round(float(jaux["moe_drop_rate"]) * n)
    np.testing.assert_allclose(float(taux["moe_drop_rate"]), float(jaux["moe_drop_rate"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(taux["moe_aux_loss"]), float(jaux["moe_aux_loss"]),
                               rtol=1e-6)
    torch.testing.assert_close(tmoe.moe_forward(tp, torch.from_numpy(x), tcfg), got,
                               rtol=0, atol=0)
    if case == "ample":
        assert float(taux["moe_drop_rate"]) == 0.0
        probs = torch.softmax(torch.from_numpy(x) @ tp["router"], -1)
        g, ids = torch.topk(probs, tcfg.top_k, -1)
        g = g / g.sum(-1, keepdim=True)
        dense = torch.zeros_like(got)
        for e in range(tcfg.n_experts):
            xe = torch.from_numpy(x)
            oe = (torch.nn.functional.silu(xe @ tp["w_gate"][e]) * (xe @ tp["w_up"][e])) \
                @ tp["w_down"][e]
            for kk in range(tcfg.top_k):
                dense += torch.where((ids[..., kk] == e)[..., None], oe * g[..., kk, None], 0.0)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-5, atol=2e-5)
    if case == "tiny":
        assert float(taux["moe_drop_rate"]) > 0.5


@pytest.mark.parametrize("s,cap", [(1, 8), (12, 8), (1024, 320)])
def test_row_capacity_matches_reference(s, cap):
    """Slots per (row, expert): at least 8, a multiple of 8; granite at a
    1024-token prefill takes 1.25 · 1024 · 8 / 32 = 320."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config
    assert tmoe.row_capacity(s, get_config(GRANITE)) == cap
    assert tmoe.row_capacity(s, get_config(GRANITE)) == jmoe._row_capacity(
        s, j_get_config(GRANITE))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_cfgs():
    return j_get_smoke(DEEPSEEK), get_smoke(DEEPSEEK)


@pytest.mark.parametrize("chunked", [False, True], ids=["direct", "q_chunked"])
def test_mla_full_matches_reference(chunked, rng, monkeypatch):
    """``mla_full`` (direct form, f32 logits) against the JAX function, in
    one block and, with the chunk threshold lowered in both packages (16
    rows, chunks of 8), over query chunks: 4 chunk blocks run."""
    jcfg, tcfg = _mla_cfgs()
    b, s = 2, 32
    if chunked:
        monkeypatch.setattr(jref, "ATTN_CHUNK_THRESHOLD", 16)
        monkeypatch.setattr(jmla, "MLA_CHUNK", 8)
        monkeypatch.setattr(tref, "ATTN_CHUNK_THRESHOLD", 16)
        monkeypatch.setattr(tmla, "MLA_CHUNK", 8)
    blocks = []
    attend = tmla._attend_block
    monkeypatch.setattr(tmla, "_attend_block", lambda *a: blocks.append(a[5]) or attend(*a))
    p = _arrays(tmla.mla_specs(tcfg), rng)
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jp, tp = _both(p)
    want = jmla.mla_full(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = tmla.mla_full(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert blocks == ([0, 8, 16, 24] if chunked else [0])


def test_mla_prefill_then_absorbed_decode_matches_reference(rng):
    """``mla_prefill`` of 9 tokens into a 16-position cache, then 3 absorbed
    ``mla_decode`` steps, against the JAX functions: outputs and every cache
    leaf (kpos exactly, empty slots -1).  The absorbed decode also equals
    the direct form over the whole sequence (the last row of ``mla_full``)."""
    jcfg, tcfg = _mla_cfgs()
    b, s, t = 2, 9, 16
    p = _arrays(tmla.mla_specs(tcfg), rng)
    xs = rng.standard_normal((b, s + 3, tcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jp, tp = _both(p)
    jcache = jax.tree_util.tree_map(lambda a: a[0], jmla.init_mla_cache(jcfg, 1, b, t, jnp.float32))
    tcache = build_model(tcfg).reset_cache(
        tree_map(lambda a: a[0], alloc_tree(tmla.mla_cache_specs(tcfg, 1, b, t))))
    want, jcache = jmla.mla_prefill(jp, jnp.asarray(xs[:, :s]), jcfg, jnp.asarray(pos), jcache)
    got, tcache = tmla.mla_prefill(tp, torch.from_numpy(xs[:, :s]), tcfg, torch.from_numpy(pos),
                                   tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(3):
        jpos = jnp.int32(s + i)
        want, jcache = jmla.mla_decode(jp, jnp.asarray(xs[:, s + i:s + i + 1]), jcfg, jpos, jcache)
        got, tcache = tmla.mla_decode(tp, torch.from_numpy(xs[:, s + i:s + i + 1]), tcfg,
                                      torch.tensor(s + i, dtype=torch.int32), tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {i}")
        for name in ("c_kv", "k_pe"):
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **TOL,
                                       err_msg=name)
        np.testing.assert_array_equal(tcache["kpos"].numpy(), np.asarray(jcache["kpos"]))
    assert (tcache["kpos"][:, s + 3:] == -1).all()
    full_pos = torch.arange(s + 3, dtype=torch.int32).expand(b, s + 3)
    direct = tmla.mla_full(tp, torch.from_numpy(xs), tcfg, full_pos)
    np.testing.assert_allclose(got[:, 0].numpy(), direct[:, -1].numpy(), **TOL)


# ---------------------------------------------------------------------------
# deepseek's layer0 cache in the decode state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
def test_init_cache_matches_reference(arch):
    """The empty cache, leaf by leaf: zero latents or K/V, every ``kpos``
    -1, ``layer0`` ones included (``DecoderLM.reset_cache`` names them by
    their last key)."""
    jmodel, _ = T._jax(arch)
    model = build_model(get_smoke(arch))
    want = T._named(jmodel.init_cache(3, 10))
    got = dict(tree_flatten(model.init_cache(3, 10)))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[name], err_msg=name)
    if arch == DEEPSEEK:
        assert got["['layer0']['kpos']"].shape == (3, 10)
        assert (got["['layer0']['kpos']"] == -1).all()


@pytest.mark.parametrize("leaf,full,row", [
    ("layer0 c_kv", (3, 10, 32), (1, 10, 32)), ("layer0 kpos", (3, 10), (1, 10)),
    ("scan c_kv", (2, 3, 10, 32), (2, 1, 10, 32)), ("one scanned layer kpos", (1, 3, 10), (1, 1, 10)),
    ("one slot, layer0 c_kv", (1, 10, 32), (1, 10, 32)), ("one slot, layer0 kpos", (1, 10), (1, 10)),
    ("one slot, scan c_kv", (2, 1, 10, 32), (2, 1, 10, 32))])
def test_splice_row_on_deepseek_cache_leaves_matches_reference(leaf, full, row, rng):
    """The admission splice on deepseek's cache leaves against the JAX
    package's ``_splice_row``: the unstacked ``layer0`` leaves (B, T, r) take
    the slot on axis 0, the stacked ones (L, B, T, r) on axis 1 (also with
    one scanned layer, the 2-layer cut's).  With one slot a leaf and its row
    have one shape; the splice takes the whole row there, as the reference's
    update does."""
    fa = rng.standard_normal(full).astype(np.float32)
    ra = rng.standard_normal(row).astype(np.float32)
    for slot in range(full[0] if leaf.startswith("layer0") else full[1]):
        want = np.asarray(jlm._splice_row(jnp.asarray(fa), jnp.asarray(ra), slot))
        got = tlm._splice_row(torch.from_numpy(fa.copy()), torch.from_numpy(ra), slot)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{leaf} slot {slot}")
    if full == row:
        np.testing.assert_array_equal(got.numpy(), ra)


def test_lmserver_deepseek_state_stays_on_the_device():
    """deepseek's state (MLA latents, the unstacked layer0 cache) too."""
    T._state_stays_on_the_device(DEEPSEEK)


@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
def test_one_slot_lmserver_matches_reference(arch):
    """``LMServer(batch=1)``: each admission splices a row state of the
    state's own shape (the whole-row splice), 4 prompts in turn; tokens
    equal the JAX LMServer's."""
    jmodel, jparams = T._jax(arch)
    model, weights = T._port(arch)
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, model.cfg.vocab, n)) for n in (4, 9, 4, 6)]
    jsrv = JServer(jmodel, jparams, batch=1, max_len=T.MAX_LEN,
                   sampling=JSampling(max_new_tokens=4))
    tsrv = LMServer(model, weights, batch=1, max_len=T.MAX_LEN,
                    sampling=SamplingConfig(max_new_tokens=4), app=T._cpu_app())
    for pr in prompts:
        jsrv.submit(pr)
        tsrv.submit(pr)
    want = jsrv.run()
    assert tsrv.run() == want
    assert (tsrv.steps, tsrv.admitted) == (jsrv.steps, jsrv.admitted)


def test_decoder_kernel_names_follow_the_config():
    """MLA attention is plain torch: an MLA config's forward launches the
    rmsnorm kernel only; the other decoders also flash attention."""
    assert build_model(get_smoke(DEEPSEEK)).kernel_names == ("rmsnorm",)
    for arch in (GRANITE, "minitron-8b", "qwen3-14b"):
        assert build_model(get_smoke(arch)).kernel_names == ("rmsnorm", "flash_attention")


# ---------------------------------------------------------------------------
# the launch scripts' --arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["minitron-8b", GRANITE, DEEPSEEK])
def test_serve_lm_example_serves_the_arch_on_a_cpu_app(arch, capsys):
    """``repro_torch.launch.serve_lm --cpu --arch A``: A's SMOKE config
    serves 10 requests of 16 tokens, its decode side moving nothing host
    to device, then the whisper part."""
    from repro_torch.launch import serve_lm

    out = serve_lm.main(["--cpu", "--arch", arch])
    assert [len(r) for r in out[arch]] == [16] * 10
    assert [len(r) for r in out["whisper"]] == [8] * 4
    text = capsys.readouterr().out
    assert f"[{arch}] served 10 requests" in text
    assert "decode-side host2device on the cache edge: 0.000000s" in text


@pytest.mark.parametrize("arch", ["minitron-8b", GRANITE, DEEPSEEK])
def test_lm_step_profile_takes_the_arch_and_needs_the_card(arch):
    """``lm_step_profile.py --arch A --layers 2`` (deepseek: layer 0 and one
    stacked layer) parses and then refuses to run without a CUDA card: it
    is a measurement of the card and has no CPU run.  An architecture the
    port does not serve is refused by the parser."""
    script = ROOT / "src/repro_torch/launch/lm_step_profile.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(script), "--arch", arch, "--layers", "2"],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0 and "no CUDA card" in r.stderr, r.stderr[-2000:]
    r = subprocess.run([sys.executable, str(script), "--arch", "mamba-130m"],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 2 and "invalid choice" in r.stderr, r.stderr[-2000:]
