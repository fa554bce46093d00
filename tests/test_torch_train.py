"""The port's training path against the JAX package's on the CPU, on
inputs made from a numpy seed: the data stream (byte for byte), the loss
and every gradient leaf on the SMOKE configs of qwen3-14b, h2o-danube-1.8b
(window 8), qwen2-7b, minitron-8b, granite-moe-1b-a400m,
deepseek-v2-lite-16b, internvl2-2b (with its patch prefix), rwkv6-3b,
zamba2-2.7b and whisper-large-v3 (with its frames), three train steps
(plain, two microbatches, compressed gradients; plain for each of the last
three families), the trainer's fault-tolerance cases of
``tests/test_trainer_ft.py`` on the port, the captured ``TrainProcess``
through a recorder in the capture seam, the launchers, and the plain
backward versions of the norm and attention kernels, with plain-torch
walks of the CUDA backward kernels' tiling and an emulation of the bf16
tensor-core backward's arithmetic (held to ``jax.vjp`` within 2e-2 x max
|grad|, the band ``chip_smoke.py`` holds the card to).

Tolerances: the loss within rtol 1e-5 of the reference's (with
``use_pallas=False``, and with ``use_pallas=True``: interpret-mode Pallas
forward, which ``jax.grad`` does not differentiate); every gradient leaf
within rtol 1e-4 and atol 1e-6 x its max |grad| of ``jax.grad`` (two
frameworks summing in other orders; measured up to 1.6e-6 x max |grad|
on the dense and VLM configs), except the two MoE configs (granite-moe,
deepseek-v2-lite), at atol 1e-5 x max |grad|: their gradients differ by
2.4e-6 to 4.8e-6 x max |grad| over three seeds, in elements whose
contributions cancel to under 1 % of the leaf's max (the router's
softmax, top-k gates and capacity dispatch sit between the loss and
every earlier leaf); zamba2-2.7b at atol 2e-5 x max |grad| (the packages
differ by 9.6e-6 to 1.07e-5 over three seeds; the reference's own eager
and jitted gradients differ by up to 8.3e-6, and each package's f32
gradient is 4.8e-6 to 8.6e-6 from an f64 run of the port); rwkv6-3b at
atol 3e-4 x max |grad| (the packages differ by 1.5e-5 to 1.06e-4 over
three seeds: the SMOKE model's gradient is ill-conditioned in f32, each
package's f32 gradient lying 2.1e-5 to 2.0e-4 from an f64 run of the
port, the port's no farther than the reference's, which
``test_f32_gradients_are_as_close_to_f64_as_the_reference`` holds); after
three train steps at lr 1e-3
every state leaf within atol 2e-5 (measured: 2.6e-6), except with
compressed gradients, where a value on a rounding edge of the int8 code
takes the neighbouring code in the other package: there the parameters and
moments within atol 1e-4 (one code of one element moves its Adam step by
a share of lr) and at most 1e-3 of the error-feedback entries off by one
code.  Restart equality is exact.
"""
import contextlib
import math
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.data import pipeline as jpipe
from repro.models import build_model as j_build_model
from repro.models import layers as jlayers
from repro.kernels import ref as jref
from repro.optim import AdamWConfig as JAdamWConfig, Schedule as JSchedule
from repro.train import (TrainConfig as JTrainConfig, make_train_state as j_make_train_state,
                         make_train_step as j_make_train_step, state_pspecs as j_state_pspecs)
from repro_torch import interop
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import process as process_mod
from repro_torch.core import registry
from repro_torch.core.app import NoMatchingDeviceError
from repro_torch.core.arena import tree_flatten, tree_unflatten
from repro_torch.core.registry import KernelRegistry, launch_counts, reset_launch_counts
from repro_torch.data import io as tio
from repro_torch.data.pipeline import ArenaFeed, FileCorpus, StreamConfig, TokenStream
from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import BWD_TILE, flash_attention_bwd
from repro_torch.kernels.rmsnorm import BWD_BLOCKS, rmsnorm_bwd
from repro_torch.launch import train as train_launch
from repro_torch.launch import train_lm
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.optim import AdamWConfig, Schedule
from repro_torch.train import (StepTimeout, TrainConfig, Trainer, TrainerConfig, TrainProcess,
                               make_train_state, make_train_step, state_pspecs)
from test_torch_lm import _named, stable_keys
from test_torch_lm_kernels import _mma_flash_emulation

ARCHS = ["qwen3-14b", "h2o-danube-1.8b", "qwen2-7b", "minitron-8b", "granite-moe-1b-a400m",
         "deepseek-v2-lite-16b", "internvl2-2b", "rwkv6-3b", "zamba2-2.7b", "whisper-large-v3"]
#: the ssm, hybrid and encdec families
NEW_FAMILIES = ["rwkv6-3b", "zamba2-2.7b", "whisper-large-v3"]
ENC_FRAMES = 10                # whisper's frames a sample in these tests
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
#: a family's atol x max |grad| where it differs from GRAD_ATOL (see the
#: module docstring)
FAMILY_GRAD_ATOL = {"moe": 1e-5, "hybrid": 2e-5, "ssm": 3e-4}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

STREAMS = {"lm": dict(vocab=100, seq=8, batch=3, seed=3),
           "vlm": dict(vocab=128, seq=6, batch=2, seed=1, kind="vlm", n_patches=4, d_model=16),
           "encdec": dict(vocab=50, seq=5, batch=2, seed=2, kind="encdec", d_model=8,
                          enc_frames=7)}


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_token_stream_matches_reference_byte_for_byte(kind):
    for shard in (0, 2):
        a = TokenStream(StreamConfig(**STREAMS[kind]), shard_id=shard, n_shards=4)
        b = jpipe.TokenStream(jpipe.StreamConfig(**STREAMS[kind]), shard_id=shard, n_shards=4)
        for step in (0, 5, 1000):
            got, want = a.batch_at(step), b.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


def test_stream_is_deterministic_and_sharded():
    c = StreamConfig(vocab=100, seq=8, batch=2, seed=3)
    a, b = TokenStream(c, shard_id=0, n_shards=4), TokenStream(c, shard_id=1, n_shards=4)
    np.testing.assert_array_equal(a.batch_at(5)["tokens"], a.batch_at(5)["tokens"])
    assert not np.array_equal(a.batch_at(5)["tokens"], b.batch_at(5)["tokens"])
    assert not np.array_equal(a.batch_at(5)["tokens"], a.batch_at(6)["tokens"])
    first = next(iter(a))
    np.testing.assert_array_equal(first["labels"], a.batch_at(0)["labels"])


def test_arena_feed_matches_reference():
    cfg = STREAMS["vlm"]
    feed = ArenaFeed(TokenStream(StreamConfig(**cfg)), steps=3, start=2)
    jfeed = jpipe.ArenaFeed(jpipe.TokenStream(jpipe.StreamConfig(**cfg)), steps=3, start=2)
    assert feed.layout.to_json() == jfeed.layout.to_json()
    blobs, jblobs = list(feed), list(jfeed)
    assert len(blobs) == 3 and all(a.tobytes() == b.tobytes() for a, b in zip(blobs, jblobs))
    assert set(feed.data_at(2).names) == {"tokens", "labels", "patch_embeds"}


def test_file_corpus_matches_reference(tmp_path):
    path = str(tmp_path / "corpus.npz")
    tio.save_npz(path, {"tokens": np.arange(1000, dtype=np.int32) % 97})
    a = FileCorpus(path, seq=16, batch=3, shard_id=1, n_shards=2)
    b = jpipe.FileCorpus(path, seq=16, batch=3, shard_id=1, n_shards=2)
    for step in (0, 7, 40):
        for k in ("tokens", "labels"):
            assert a.batch_at(step)[k].tobytes() == b.batch_at(step)[k].tobytes()


# ---------------------------------------------------------------------------
# the decoder family's loss and gradients
# ---------------------------------------------------------------------------

def _jax_model(arch, use_pallas=False):
    cfg = j_get_smoke(arch).scaled(use_pallas=use_pallas)
    model = j_build_model(cfg)
    with stable_keys():
        return cfg, model, model.init_params(jax.random.key(0))


def _batch(cfg, seed=0, b=2, s=12, mask=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model)) \
            .astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, ENC_FRAMES, cfg.d_model)).astype(np.float32)
    if mask:
        batch["loss_mask"] = (rng.random((b, s)) < 0.6).astype(np.float32)
    return batch


def _port_params(jparams):
    return {n: torch.tensor(v).requires_grad_(True) for n, v in _named(jparams).items()}


def _port_loss_and_grads(arch, jparams, batch, **overrides):
    model = build_model(get_smoke(arch).scaled(**overrides))
    leaves = _port_params(jparams)
    total, metrics = model.loss_fn(tree_unflatten(leaves.items()),
                                   {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    return total, metrics, {n: t.grad for n, t in leaves.items()}


def _assert_grads(port, jgrads, atol=GRAD_ATOL):
    want = _named(jgrads)
    assert set(port) == set(want)
    for name, g in port.items():
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=atol * float(np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax_grad(arch):
    cfg, jmodel, jparams = _jax_model(arch)
    batch = _batch(cfg)
    (jtotal, jmetrics), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(jparams,
                                                                                   batch)
    total, metrics, grads = _port_loss_and_grads(arch, jparams, batch)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _assert_grads(grads, jgrads, FAMILY_GRAD_ATOL.get(cfg.family, GRAD_ATOL))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_f32_gradients_are_as_close_to_f64_as_the_reference(arch, monkeypatch):
    """Where the packages' f32 gradients differ by more than GRAD_ATOL, the
    truth is an f64 run of the port (f64 parameters, and every ``.float()``
    of the model and the plain kernels made ``.double()``): the port's f32
    gradient is no more than 1.5 x as far from it as the reference's (the
    worst leaf, in units of its max |grad|)."""
    cfg, jmodel, jparams = _jax_model(arch)
    batch = _batch(cfg)
    _, jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(jparams, batch)
    grads = _port_loss_and_grads(arch, jparams, batch)[2]
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    model = build_model(get_smoke(arch).scaled(param_dtype="float64", dtype="float64"))
    leaves = {n: torch.tensor(np.asarray(v), dtype=torch.float64).requires_grad_(True)
              for n, v in _named(jparams).items()}
    total, _ = model.loss_fn(tree_unflatten(leaves.items()),
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    truth = {n: t.grad.numpy() for n, t in leaves.items()}

    def worst(got):
        return max(float(np.abs(np.asarray(got[n], np.float64) - w).max() / np.abs(w).max())
                   for n, w in truth.items())

    port, reference = worst({n: g.numpy() for n, g in grads.items()}), worst(_named(jgrads))
    assert port <= 1.5 * reference, (port, reference)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_reference_with_pallas(arch):
    """The reference's forward through its Pallas kernels (interpret mode)."""
    cfg, jmodel, jparams = _jax_model(arch, use_pallas=True)
    batch = _batch(cfg, seed=1)
    jtotal, _ = jax.jit(jmodel.loss_fn)(jparams, batch)
    model = build_model(get_smoke(arch))
    with torch.no_grad():
        total, _ = model.loss_fn(tree_unflatten((n, torch.tensor(v)) for n, v in
                                                _named(jparams).items()),
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)


def test_loss_mask_and_cross_entropy_match_reference():
    cfg, jmodel, jparams = _jax_model("qwen3-14b")
    batch = _batch(cfg, seed=2, mask=True)
    (jtotal, _), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(jparams, batch)
    total, _, grads = _port_loss_and_grads("qwen3-14b", jparams, batch)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    _assert_grads(grads, jgrads)
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = np.zeros((2, 5), np.float32)
    for m in (None, mask):
        got = tlayers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                    None if m is None else torch.from_numpy(m))
        want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v2-lite-16b", "rwkv6-3b",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_remat_leaves_loss_and_gradients_bit_for_bit(arch):
    """Recomputing each stacked layer (zamba2: each superblock; whisper:
    each encoder and decoder layer) in the backward gives the same numbers
    as keeping its activations."""
    cfg, _, jparams = _jax_model(arch)
    batch = _batch(cfg, seed=4)
    a = _port_loss_and_grads(arch, jparams, batch, remat=True)
    b = _port_loss_and_grads(arch, jparams, batch, remat=False)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[2][n], b[2][n]) for n in a[2])


def test_logits_and_hidden_states_shapes():
    cfg = get_smoke("internvl2-2b")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.zeros((2, 5), dtype=torch.int32)
    prefix = torch.zeros((2, cfg.n_patches, cfg.d_model))
    logits, aux = model.logits(params, toks, prefix)
    assert logits.shape == (2, cfg.n_patches + 5, cfg.vocab) and logits.dtype == torch.float32
    assert aux == {}
    x, _ = model.hidden_states(params, toks)
    assert x.shape == (2, 5, cfg.d_model)


# ---------------------------------------------------------------------------
# train steps against the reference's
# ---------------------------------------------------------------------------

def _j_named(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mode", ["plain", "microbatches", "compress"])
def test_three_train_steps_match_reference(mode):
    arch = "qwen3-14b"
    mb, comp = (2, False) if mode == "microbatches" else (1, mode == "compress")
    jcfg = j_get_smoke(arch)
    jmodel = j_build_model(jcfg)
    with stable_keys():
        jstate = j_make_train_state(jmodel, jax.random.key(0), compress=comp)
    state = interop.train_state_from_reference(
        {jax.tree_util.keystr(p): np.asarray(v)
         for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}, get_smoke(arch), "cpu")
    sched = dict(kind="constant", base_lr=1e-3, warmup_steps=0)
    jstep = jax.jit(j_make_train_step(jmodel, JTrainConfig(
        microbatches=mb, compress_grads=comp, opt=JAdamWConfig(schedule=JSchedule(**sched)))))
    step = make_train_step(build_model(get_smoke(arch)), TrainConfig(
        microbatches=mb, compress_grads=comp, opt=AdamWConfig(schedule=Schedule(**sched))))
    stream = TokenStream(StreamConfig(vocab=jcfg.vocab, seq=12, batch=4))
    for i in range(3):
        batch = stream.batch_at(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    want = _j_named(jstate)
    got = {n: t.float().numpy() for n, t in tree_flatten(state)}
    assert set(got) == set(want)
    atol = 1e-4 if comp else 2e-5
    for name in got:
        if name.startswith("['ef']"):
            off = np.abs(got[name] - want[name]) > 1e-5
            assert off.mean() <= 1e-3 + 1.0 / off.size, name
            assert np.abs(got[name] - want[name]).max() <= 2 * np.abs(want[name]).max(), name
        else:
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol, err_msg=name)
    assert int(state["opt"]["step"]) == 3


def _stream_config(cfg, **kw):
    """The TokenStream of ``cfg``'s family (whisper's carries frames)."""
    if cfg.family == "encdec":
        kw.update(kind="encdec", d_model=cfg.d_model, enc_frames=ENC_FRAMES)
    return StreamConfig(vocab=cfg.vocab, **kw)


#: (grad_norm rtol, parameter and master atol) of three steps of the
#: ssm, hybrid and encdec families: the loss within rtol 1e-5
#: and m and v within atol 2e-5 as for the decoder family (measured up to
#: 2.9e-6), but AdamW divides m by sqrt(v), so an element whose gradient
#: sits at the packages' f32 gap moves by up to lr (1e-3) either way: the
#: parameters measured up to 1.1e-4 (rwkv6), 3.4e-5 (zamba2) and 2.8e-5
#: (whisper) apart; grad_norm up to 2.5e-4 (rwkv6), 3.6e-5 (zamba2) and
#: 5.4e-7 (whisper) apart, as the gradient bands above say
STEP_BANDS = {"ssm": (1e-3, 2e-4), "hybrid": (1e-4, 1e-4), "encdec": (1e-5, 1e-4)}


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_three_train_steps_match_reference_for_each_family(arch):
    """rwkv6, zamba2 and whisper: three plain steps from the reference's
    state within :data:`STEP_BANDS`."""
    jcfg = j_get_smoke(arch)
    jmodel = j_build_model(jcfg)
    with stable_keys():
        jstate = j_make_train_state(jmodel, jax.random.key(0))
    state = interop.train_state_from_reference(
        {jax.tree_util.keystr(p): np.asarray(v)
         for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}, get_smoke(arch), "cpu")
    sched = dict(kind="constant", base_lr=1e-3, warmup_steps=0)
    jstep = jax.jit(j_make_train_step(jmodel, JTrainConfig(
        opt=JAdamWConfig(schedule=JSchedule(**sched)))))
    step = make_train_step(build_model(get_smoke(arch)), TrainConfig(
        opt=AdamWConfig(schedule=Schedule(**sched))))
    norm_rtol, param_atol = STEP_BANDS[jcfg.family]
    stream = TokenStream(_stream_config(get_smoke(arch), seq=12, batch=4))
    for i in range(3):
        batch = stream.batch_at(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        for k, rtol in (("loss", 1e-5), ("grad_norm", norm_rtol), ("lr", 1e-5)):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol, err_msg=k)
    want = _j_named(jstate)
    got = {n: t.float().numpy() for n, t in tree_flatten(state)}
    assert set(got) == set(want)
    for name in got:
        atol = 2e-5 if name.startswith(("['opt']['m']", "['opt']['v']")) else param_atol
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol, err_msg=name)
    assert int(state["opt"]["step"]) == 3


def test_train_state_from_reference_refuses_another_model():
    with stable_keys():
        jstate = j_make_train_state(j_build_model(j_get_smoke("qwen3-14b")), jax.random.key(0))
    named = {jax.tree_util.keystr(p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    with pytest.raises(ValueError, match="missing"):
        interop.train_state_from_reference(named, get_smoke("qwen2-7b"), "cpu")
    state = interop.train_state_from_reference(named, get_smoke("qwen3-14b"), "cpu")
    assert state["opt"]["step"].dtype == torch.int32 and state["opt"]["step"].shape == ()
    assert "ef" not in state


def test_state_specs_wait_for_the_multi_gpu_slice():
    """The multi-GPU slice came (the name is the refusal's this test
    replaced): ``state_pspecs`` of a qwen3-14b SMOKE state is the
    reference's (every family: ``tests/test_torch_train_mesh.py``)."""
    model = build_model(get_smoke("qwen3-14b"))
    specs = dict(tree_flatten(state_pspecs(model, make_train_state(model, 0, compress=True, device="cpu"))))
    assert specs["['params']['embed']['embedding']"] == ("model", None)
    assert specs["['opt']['master']['embed']['embedding']"] == ("model", "data")
    assert specs["['ef']['layers']['attn']['w_o']"] == (None, "model", "data")
    assert specs["['opt']['step']"] == ()
    jstate = jax.eval_shape(lambda: j_make_train_state(
        j_build_model(j_get_smoke("qwen3-14b")), jax.random.key(0), compress=True))
    want = jax.tree_util.tree_flatten_with_path(j_state_pspecs(
        j_build_model(j_get_smoke("qwen3-14b")), jstate),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert {jax.tree_util.keystr(p): tuple(v) for p, v in want} == specs


# ---------------------------------------------------------------------------
# the trainer (tests/test_trainer_ft.py's cases on the port)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke("qwen3-14b")
    return cfg, build_model(cfg), TokenStream(StreamConfig(vocab=cfg.vocab, seq=16, batch=4))


def _max_param_diff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for (_, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)))


def _trainer(model, tmp=None, **kw):
    return Trainer(model, TrainerConfig(ckpt_dir=tmp, **kw), device="cpu", log_fn=lambda s: None)


def test_loss_decreases(setup, tmp_path):
    cfg, model, stream = setup
    tr = _trainer(model, str(tmp_path), total_steps=40, log_every=2)
    tr.fit(stream, 0)
    losses = [loss for _, loss in tr.history]
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_restart_equivalence(setup, tmp_path):
    """Crash at step 6 + resume == uninterrupted run, bit for bit."""
    cfg, _, stream = setup
    s_ref = _trainer(build_model(cfg), str(tmp_path / "a"), total_steps=8, ckpt_interval=2,
                     log_every=5).fit(stream, 0)
    t_rec = _trainer(build_model(cfg), str(tmp_path / "b"), total_steps=8, ckpt_interval=2,
                     log_every=5)
    s_rec = t_rec.fit_with_restarts(stream, 0, failure_schedule=[6])
    assert _max_param_diff(s_ref, s_rec) == 0.0


def test_double_failure_recovery(setup, tmp_path):
    cfg, _, stream = setup
    t = _trainer(build_model(cfg), str(tmp_path / "c"), total_steps=6, ckpt_interval=1,
                 log_every=5)
    s = t.fit_with_restarts(stream, 0, failure_schedule=[2, 4])
    assert s is not None and int(s["opt"]["step"]) == 6


def test_straggler_timeout_raises(setup, tmp_path):
    cfg, model, stream = setup
    t = _trainer(model, str(tmp_path / "d"), total_steps=3, step_timeout_s=1e-9)
    with pytest.raises(StepTimeout):
        t.fit(stream, 0)


def test_grad_accumulation_equivalence(setup):
    cfg, model, stream = setup
    batch = stream.batch_at(0)
    s1, s2 = make_train_state(model, 1, device="cpu"), make_train_state(model, 1, device="cpu")
    n1, _ = make_train_step(model, TrainConfig(microbatches=1))(s1, batch)
    n2, _ = make_train_step(model, TrainConfig(microbatches=4))(s2, batch)
    assert _max_param_diff(n1["params"], n2["params"]) < 3e-5


def test_compressed_grads_trains(setup):
    cfg, model, stream = setup
    s = make_train_state(model, 1, compress=True, device="cpu")
    step = make_train_step(model, TrainConfig(compress_grads=True))
    for i in range(3):
        s, m = step(s, stream.batch_at(i))
    assert np.isfinite(float(m["loss"]))
    assert sum(float(e.abs().sum()) for _, e in tree_flatten(s["ef"])) > 0


def test_one_rng_gives_the_same_parameters(setup):
    cfg, model, _ = setup
    g = torch.Generator().manual_seed(5)
    a, b = make_train_state(model, g, device="cpu"), make_train_state(model, g, device="cpu")
    assert _max_param_diff(a, b) == 0.0
    assert _max_param_diff(a, make_train_state(model, 5, device="cpu")) == 0.0


def test_trainer_refuses_a_mesh_and_needs_a_card_unless_asked(setup, monkeypatch):
    """A mesh that cannot run is refused before anything is placed: a
    model axis that does not divide the vocabulary (rwkv6 SMOKE's 128 over
    3 lanes), a card that is not present."""
    cfg, model, _ = setup
    rwkv = build_model(get_smoke("rwkv6-3b"))
    with pytest.raises(ValueError, match=r"RWKV6Model \['embed'\]\['embedding'\] .* does not "
                       "split into 3 pieces"):
        Trainer(rwkv, TrainerConfig(), mesh=make_data_mesh([torch.device("cpu")] * 3, model=3),
                device="cpu")
    Trainer(rwkv, TrainerConfig(), mesh=make_data_mesh([torch.device("cpu")] * 2, model=2))
    with pytest.raises(NoMatchingDeviceError, match="not present"):
        Trainer(rwkv, TrainerConfig(), mesh=make_data_mesh([torch.device("cuda", 7)] * 2,
                                                           model=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, TrainerConfig())


# ---------------------------------------------------------------------------
# TrainProcess: the captured step, through a recorder in the capture seam
# ---------------------------------------------------------------------------

class _Streams:
    """Stands in for torch.cuda's stream calls, which the CPU lacks."""

    class Stream:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass

    @staticmethod
    def stream(s):
        return contextlib.nullcontext()


@pytest.fixture
def captured(monkeypatch):
    """TrainProcess as on the card: the capture runs the body and puts
    back every tensor of ``rec.state`` (a real capture runs nothing); each
    replay runs the body.  ``ref.rmsnorm`` / ``ref.attention`` count a
    launch, as their kernels do."""
    rec = types.SimpleNamespace(events=[], state=None)

    def capture(body, device):
        rec.events.append("capture")
        before = [t.clone() for _, t in tree_flatten(rec.state)]
        body()
        for (_, t), b in zip(tree_flatten(rec.state), before):
            t.copy_(b)

        def replay():
            rec.events.append("replay")
            body()
        return replay

    monkeypatch.setattr(process_mod, "_graphs_on", lambda device: True)
    monkeypatch.setattr(process_mod, "capture_graph", capture)
    monkeypatch.setattr(torch.cuda, "Stream", _Streams.Stream)
    monkeypatch.setattr(torch.cuda, "stream", _Streams.stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Streams.Stream())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for fn, kname in (("rmsnorm", "rmsnorm"), ("attention", "flash_attention")):
        def counted(*a, _plain=getattr(ref, fn), _name=kname, **kw):
            registry.count_launch(_name)
            return _plain(*a, **kw)
        monkeypatch.setattr(ref, fn, counted)
    reset_launch_counts()
    return rec


def test_train_process_replays_the_eager_steps_bit_for_bit(setup, captured):
    cfg, model, stream = setup
    tcfg = TrainConfig(opt=AdamWConfig(schedule=Schedule(kind="constant", base_lr=1e-3,
                                                         warmup_steps=0)))
    state = captured.state = make_train_state(model, 2, device="cpu")
    proc = TrainProcess(model, tcfg).init(state, stream.batch_at(0))
    assert captured.events == ["capture"] and int(state["opt"]["step"]) == 0
    eager = make_train_state(model, 2, device="cpu")
    step = make_train_step(model, tcfg)
    per_step = {"rmsnorm": 2 * (4 * cfg.n_layers) + 1, "flash_attention": 2 * cfg.n_layers}
    for i in range(3):
        out, metrics = proc.launch(state, stream.batch_at(i))
        eager, want = step(eager, stream.batch_at(i))
        assert out is state and torch.equal(metrics["loss"], want["loss"])
    assert (proc.captures, proc.replays) == (1, 3)
    assert captured.events == ["capture"] + ["replay"] * 3
    assert _max_param_diff(state, eager) == 0.0
    # init's warm-up forward and backward, the capture's tally once a
    # replay (the recorder's runs of the body count into that tally, not
    # the launch counts), and the eager steps' own launches
    counts = launch_counts()
    assert {k: counts[k] for k in per_step} == {k: (1 + 3 + 3) * v
                                                for k, v in per_step.items()}
    with pytest.raises(ValueError, match="captured"):
        proc.launch(eager, stream.batch_at(0))
    with pytest.raises(ValueError, match="shape"):
        proc.launch(state, {k: v[:2] for k, v in stream.batch_at(0).items()})


def test_train_process_on_the_cpu_runs_eagerly(setup):
    cfg, model, stream = setup
    state = make_train_state(model, 0, device="cpu")
    proc = TrainProcess(model, TrainConfig())
    with pytest.raises(RuntimeError, match="init"):
        proc.launch(state, stream.batch_at(0))
    proc.init(state, stream.batch_at(0))
    _, m = proc.launch(state, stream.batch_at(0))
    assert (proc.captures, proc.replays) == (0, 0) and int(state["opt"]["step"]) == 1
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_train_launcher_trains_each_family_on_the_cpu(arch, capsys):
    """``--scale smoke --cpu``: whisper's stream is ``encdec`` and its
    batches carry max(8, seq // 2) frames a sample, as the reference's."""
    tr = train_launch.main(["--arch", arch, "--scale", "smoke", "--cpu", "--steps", "2",
                            "--batch", "2", "--seq", "12", "--log-every", "1"])
    assert [s for s, _ in tr.history] == [0, 1]
    assert all(np.isfinite(loss) for _, loss in tr.history)
    assert f"[train] {arch} (smoke) 2 steps on cpu" in capsys.readouterr().out
    if arch == "whisper-large-v3":
        cfg = get_smoke(arch)
        want = jpipe.TokenStream(jpipe.StreamConfig(vocab=cfg.vocab, seq=12, batch=2, seed=0,
                                                    kind="encdec", d_model=cfg.d_model,
                                                    enc_frames=8)).batch_at(0)
        got = TokenStream(StreamConfig(vocab=cfg.vocab, seq=12, batch=2, seed=0, kind="encdec",
                                       d_model=cfg.d_model, enc_frames=8)).batch_at(0)
        assert got["frames"].shape == (2, 8, cfg.d_model)
        assert got["frames"].tobytes() == want["frames"].tobytes()


def test_train_launcher_refuses_a_train_state_larger_than_the_card(monkeypatch):
    class Props:
        total_memory = 85_000_000_000
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props())
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    danube = train_launch.train_state_bytes(get_config("h2o-danube-1.8b"))
    assert danube == 1_831_201_280 * 16
    # two lanes on the card: two replicas, one lane's gradients at a time,
    # the master, m and v in pieces and the f32 sum of the lanes' gradients
    assert train_launch.train_state_bytes(get_config("h2o-danube-1.8b"), lanes=2) == \
        1_831_201_280 * 22
    assert train_launch.train_state_bytes(get_config("h2o-danube-1.8b"), microbatches=2) == \
        1_831_201_280 * 20
    with pytest.raises(RuntimeError, match="needs"):
        train_launch.check_fits(get_config("rwkv6-3b"), torch.device("cuda"), lanes=6)
    train_launch.check_fits(get_config("h2o-danube-1.8b"), torch.device("cuda"))
    with pytest.raises(RuntimeError, match=r"needs 23\d\.\d GB .* has 85\.0 GB"):
        train_launch.check_fits(get_config("qwen3-14b"), torch.device("cuda"))
    with pytest.raises(RuntimeError, match="train state needs"):
        train_launch.main(["--arch", "qwen3-14b", "--scale", "full"])
    with pytest.raises(RuntimeError, match=r"\{'pod': 2, 'data': 16, 'model': 16\} needs 512 "
                       "CUDA devices; 0 found"):
        train_launch.main(["--arch", "qwen3-14b", "--multi-pod", "--cpu"])
    for arch in ("rwkv6-3b", "zamba2-2.7b", "whisper-large-v3"):     # every family
        with pytest.raises(RuntimeError, match="needs 512 CUDA devices; 0 found"):
            train_launch.main(["--arch", arch, "--multi-pod", "--cpu"])


def test_train_launcher_trains_a_smoke_config_on_the_cpu(tmp_path):
    tr = train_launch.main(["--arch", "internvl2-2b", "--cpu", "--steps", "3", "--batch", "2",
                            "--seq", "12", "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    assert [s for s, _ in tr.history] == [0, 1, 2]
    assert tr.ckpt.latest() == 3


def test_train_lm_tiny_improves_on_the_cpu():
    tr = train_lm.main(["--tiny", "--cpu", "--steps", "30", "--batch", "4", "--seq", "32"])
    assert tr.history[-1][1] < tr.history[0][1]
    n = sum(math.prod(s.shape) for _, s in tree_flatten(build_model(train_lm.lm_100m())
                                                         .param_specs()))
    assert n == 124_668_672


# ---------------------------------------------------------------------------
# the kernels' plain backward versions and the CUDA kernels' tiling
# ---------------------------------------------------------------------------

def test_rmsnorm_bwd_plain_version_matches_jax_grad():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 16)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    dy = rng.standard_normal((5, 7, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm(a, b, 1e-6), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    dx, dw = ref.rmsnorm_bwd(torch.tensor(x), torch.tensor(w), torch.tensor(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-5)


ATTN_CASES = [((2, 4, 9, 16), (2, 2, 9, 16), True, None),
              ((1, 4, 11, 16), (1, 4, 11, 16), True, 3),
              ((2, 6, 5, 8), (2, 2, 9, 8), False, None)]


@pytest.mark.parametrize("qs,ks,causal,window", ATTN_CASES)
def test_attention_bwd_plain_version_matches_jax_grad(qs, ks, causal, window):
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (qs, ks, ks, qs))
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=causal, window=window),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = ref.attention_bwd(*map(torch.tensor, (q, k, v)), None, torch.tensor(do),
                            causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_backward_wrappers_on_the_cpu_are_the_plain_versions():
    reg = KernelRegistry()
    assert {"rmsnorm_bwd", "flash_attention_bwd"} <= set(reg.load(["rmsnorm",
                                                                   "flash_attention"]))
    assert reg.ref("rmsnorm_bwd") is ref.rmsnorm_bwd
    assert reg.ref("flash_attention_bwd") is ref.attention_bwd
    rng = np.random.default_rng(2)
    x, w, dy = (torch.tensor(rng.standard_normal(s).astype(np.float32))
                for s in ((3, 8), (8,), (3, 8)))
    before = launch_counts()
    for a, b in zip(rmsnorm_bwd(x, w, dy), ref.rmsnorm_bwd(x, w, dy)):
        assert torch.equal(a, b)
    q, k = torch.randn(1, 2, 5, 16), torch.randn(1, 1, 5, 16)
    for a, b in zip(flash_attention_bwd(q, k, k, q, q, None), ref.attention_bwd(q, k, k, None, q)):
        assert torch.equal(a, b)
    assert launch_counts() == before


def test_backward_wrappers_raise_off_cpu_and_cuda(monkeypatch):
    """On ``meta`` tensors (a dry run's trace) the backward wrappers give
    the plain layout without running the plain version; shapes are checked
    first."""
    def plain(*_a, **_k):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(ref, "rmsnorm_bwd", plain)
    monkeypatch.setattr(ref, "attention_bwd", plain)
    m = torch.empty((2, 8), device="meta")
    dx, dw = rmsnorm_bwd(m, torch.empty(8, device="meta"), m)
    assert (dx.device.type, tuple(dx.shape), tuple(dw.shape)) == ("meta", (2, 8), (8,))
    q = torch.empty((1, 2, 4, 16), device="meta")
    grads = flash_attention_bwd(q, q, q, q, q, torch.empty((1, 2, 4), device="meta"))
    assert [tuple(g.shape) for g in grads] == [(1, 2, 4, 16)] * 3
    assert all(g.device.type == "meta" for g in grads)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_bwd(q, q, q, q[:, :, :2], q, None)


def _bwd_tiles():
    """The backward kernels' tiles as ``lm_kernels.cu`` has them: bf16
    (``kBwdMmaTile``, the tensor-core kernels) and f32 (``kBwdTile``, the
    FMA kernels)."""
    src = (_build.CSRC / "lm_kernels.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for name in ("kBwdMmaTile", "kBwdTile")}


def test_backward_tiles_of_the_wrapper_are_the_kernels():
    tiles = _bwd_tiles()
    assert BWD_TILE == {torch.bfloat16: tiles["kBwdMmaTile"], torch.float32: tiles["kBwdTile"]}


def _flash_bwd_walk(q, k, v, o, do, lse, causal, window, tile):
    """The CUDA backward's loops in plain torch (f32): the dK/dV kernel's
    blocks over key tiles of ``tile``, each walking its group's query heads
    and the query tiles that can see it (``q_begin`` / ``q_end`` as the
    kernels compute them), and the dQ kernel's blocks over query tiles
    walking their key tiles (``k_begin`` / ``k_end``); P from the
    log-sum-exp, delta from dO and O, the masks of the kernels."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group, offset, scale = hq // hkv, skv - sq, d ** -0.5
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = (do * o).sum(-1)

    def p_ds(bi, h, q0, k0):
        qi = torch.arange(q0, min(q0 + tile, sq))
        kj = torch.arange(k0, min(k0 + tile, skv))
        s = q[bi, h, qi] @ k[bi, h // group, kj].T
        pos = (qi + offset)[:, None]
        ok = torch.ones_like(s, dtype=torch.bool)
        if causal:
            ok &= kj[None] <= pos
        if window:
            ok &= kj[None] > pos - window
        p = torch.where(ok, torch.exp(s * scale - lse[bi, h, qi][:, None]), 0.0)
        ds = p * (do[bi, h, qi] @ v[bi, h // group, kj].T - delta[bi, h, qi][:, None])
        return qi, kj, p, ds

    for bi in range(b):
        for hk in range(hkv):
            for k0 in range(0, skv, tile):
                for h, q0 in _dkdv_steps(k0, hk, group, sq, skv, causal, window, tile):
                    qi, kj, p, ds = p_ds(bi, h, q0, k0)
                    dv[bi, hk, kj] += p.T @ do[bi, h, qi]
                    dk[bi, hk, kj] += scale * ds.T @ q[bi, h, qi]
        for h in range(hq):
            for q0 in range(0, sq, tile):
                for k0 in _dq_key_tiles(q0, sq, skv, causal, window, tile):
                    qi, kj, _, ds = p_ds(bi, h, q0, k0)
                    dq[bi, h, qi] += scale * ds @ k[bi, h // group, kj]
    return dq, dk, dv


def _dkdv_steps(k0, hk, group, sq, skv, causal, window, tile):
    """(query head, query tile) of the dK/dV block of key tile ``k0``, in
    its order: the query rows that can see a key of the tile (position >=
    k0 under causality, position < last key + window)."""
    offset, k_last = skv - sq, min(k0 + tile, skv) - 1
    q_begin = (max(0, k0 - offset) if causal else 0) // tile * tile
    q_end = min(sq, k_last + window - offset) if window else sq
    return [(h, q0) for h in range(hk * group, (hk + 1) * group)
            for q0 in range(q_begin, q_end, tile)]


def _dq_key_tiles(q0, sq, skv, causal, window, tile):
    """The key tiles the dQ block of query tile ``q0`` walks (those some
    query of the tile can see)."""
    q_lo, q_hi = q0 + skv - sq, min(q0 + tile, sq) - 1 + skv - sq
    k_end = min(skv, q_hi + 1) if causal else skv
    k_begin = (max(0, q_lo - window + 1) if window else 0) // tile * tile
    return range(k_begin, k_end, tile)


WALK_SHAPES = [((1, 4, 100, 16), (1, 2, 100, 16), True, None),
               ((1, 2, 130, 16), (1, 1, 130, 16), True, 8),
               ((1, 2, 70, 16), (1, 2, 90, 16), True, 33),
               ((1, 4, 77, 16), (1, 1, 77, 16), False, None),
               ((2, 2, 64, 16), (2, 2, 64, 16), True, 40),
               ((1, 2, 45, 16), (1, 1, 45, 16), False, 10)]
# each shape at the f32 kernels' tile (kBwdTile; the ids these cases had
# before the bf16 kernels' tile came in) and the bf16 ones' (kBwdMmaTile)
WALK_CASES = [pytest.param(*case, kind, id=f"qs{i}-ks{i}-{case[2]}-{case[3]}{suffix}")
              for kind, suffix in (("kBwdTile", ""), ("kBwdMmaTile", "-mma"))
              for i, case in enumerate(WALK_SHAPES)]


def _visible_lse(q, k, causal, window, scale):
    """The forward's log-sum-exp of the scaled scores over the visible keys
    (f32; +inf for a row that sees no key)."""
    hq, sq, skv = q.shape[1], q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(hq // k.shape[1], 1)) * scale
    pos = torch.arange(sq)[:, None] + skv - sq
    kp = torch.arange(skv)[None]
    ok = torch.ones_like(pos * kp, dtype=torch.bool)
    if causal:
        ok &= kp <= pos
    if window:
        ok &= kp > pos - window
    lse = torch.logsumexp(torch.where(ok, s, -torch.inf), -1)
    return torch.where(ok.any(-1), lse, torch.inf)


@pytest.mark.parametrize("qs,ks,causal,window,kind", WALK_CASES)
def test_flash_backward_tiling_visits_every_pair_once(qs, ks, causal, window, kind):
    """The kernels' tile ranges skip only pairs that no mask lets through,
    and visit the others once: the walk equals autograd through the plain
    version, at both kernels' tiles."""
    g = torch.Generator().manual_seed(0)
    q, do = torch.randn(qs, generator=g), torch.randn(qs, generator=g)
    k, v = torch.randn(ks, generator=g), torch.randn(ks, generator=g)
    o = ref.attention(q, k, v, causal=causal, window=window)
    lse = _visible_lse(q, k, causal, window, qs[-1] ** -.5)
    got = _flash_bwd_walk(q, k, v, o, do, lse, causal, window, _bwd_tiles()[kind])
    want = ref.attention_bwd(q, k, v, o, do, causal=causal, window=window)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def _mma_flash_bwd_emulation(q, k, v, o, do, lse, causal, window):
    """The arithmetic of the bf16 backward kernels in plain torch, on bf16
    q, k, v, o and dO and the forward's f32 log-sum-exp: delta =
    rowsum(dO o) in f32 once; the dK/dV blocks over 64-key tiles walk their
    group's query heads and 64-query tiles in the kernel's order, the dQ
    blocks over 64-query tiles their key tiles; S and dP exact in f32 (bf16
    products are exact; the sums in another order than the mma's); P =
    exp2(S scale log2 e - lse log2 e) in f32, 0 where masked; dS = P (dP -
    delta); P and dS rounded to bf16 before the products, which sum in f32;
    dK and dQ times the scale, the three outputs rounded to bf16."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    tile = _bwd_tiles()["kBwdMmaTile"]
    group, offset = hq // hkv, skv - sq
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1)
    lse2 = lse * log2e

    def p_ds(bi, h, q0, k0):
        qi = torch.arange(q0, min(q0 + tile, sq))
        kj = torch.arange(k0, min(k0 + tile, skv))
        s = qf[bi, h, qi] @ kf[bi, h // group, kj].T
        dp = dof[bi, h, qi] @ vf[bi, h // group, kj].T
        pos = (qi + offset)[:, None]
        ok = torch.ones_like(s, dtype=torch.bool)
        if causal:
            ok &= kj[None] <= pos
        if window:
            ok &= kj[None] > pos - window
        p = torch.where(ok, torch.exp2(s * (scale * log2e) - lse2[bi, h, qi][:, None]), 0.0)
        ds = p * (dp - delta[bi, h, qi][:, None])
        return qi, kj, p.bfloat16().float(), ds.bfloat16().float()

    dq = torch.zeros(b, hq, sq, d)
    dk, dv = torch.zeros(b, hkv, skv, d), torch.zeros(b, hkv, skv, d)
    for bi in range(b):
        for hk in range(hkv):
            for k0 in range(0, skv, tile):
                for h, q0 in _dkdv_steps(k0, hk, group, sq, skv, causal, window, tile):
                    qi, kj, p, ds = p_ds(bi, h, q0, k0)
                    dv[bi, hk, kj] += p.T @ dof[bi, h, qi]
                    dk[bi, hk, kj] += ds.T @ qf[bi, h, qi]
        for h in range(hq):
            for q0 in range(0, sq, tile):
                for k0 in _dq_key_tiles(q0, sq, skv, causal, window, tile):
                    qi, kj, _, ds = p_ds(bi, h, q0, k0)
                    dq[bi, h, qi] += ds @ kf[bi, h // group, kj]
    return (dq * scale).bfloat16(), (dk * scale).bfloat16(), dv.bfloat16()


@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,d,causal,window",
    [
        (1, 4, 2, 130, 130, 64, True, None),   # GQA causal, three tiles each way, ragged
        (2, 4, 1, 70, 100, 80, True, 33),      # window, kv longer than q, ragged ends
        (1, 6, 2, 90, 77, 16, False, None),    # non-causal, the SMOKE head dim
    ])
def test_mma_flash_bwd_arithmetic_fits_the_bf16_tolerance(b, hq, hkv, sq, skv, d, causal,
                                                          window):
    """The bf16 backward kernels' roundings (P and dS to bf16 before the
    products, the outputs to bf16), on the bf16 forward's output, stay
    within the 2e-2 x max |grad| that ``chip_smoke.py`` holds the card's
    kernels to, against ``jax.vjp`` of the reference attention in f32 on
    the same (bf16-valued) inputs."""
    rng = np.random.default_rng(3)
    q, do = (torch.tensor(rng.standard_normal((b, hq, sq, d)), dtype=torch.bfloat16)
             for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((b, hkv, skv, d)), dtype=torch.bfloat16)
            for _ in range(2))
    o = _mma_flash_emulation(q, k, v, causal, window)
    lse = _visible_lse(q, k, causal, window, d ** -0.5)
    got = _mma_flash_bwd_emulation(q, k, v, o, do, lse, causal, window)
    _, vjp = jax.vjp(lambda a, b_, c: jref.attention(a, b_, c, causal=causal, window=window),
                     *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.float().numpy()))
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        err = np.abs(g_.float().numpy() - w).max() / np.abs(w).max()
        assert err <= 2e-2, f"{name}: {err:.3e} x max |grad|"


@pytest.mark.parametrize("rows,d", [(7, 16), (300, 40), (1000, 8)])
def test_rmsnorm_backward_block_partials_equal_the_plain_gradient(rows, d):
    """The CUDA backward's dw: per-block partials over runs of
    ceil(rows / blocks) rows (blocks = min(BWD_BLOCKS, rows)), summed in
    block order."""
    g = torch.Generator().manual_seed(1)
    x, dy = torch.randn(rows, d, generator=g), torch.randn(rows, d, generator=g)
    w = torch.randn(d, generator=g)
    blocks = min(BWD_BLOCKS, rows)
    per = -(-rows // blocks)
    r = torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6)
    parts = torch.stack([(dy * x * r)[i * per:(i + 1) * per].sum(0) for i in range(blocks)])
    dx = r * dy * w - x * r ** 3 * (dy * w * x).mean(-1, keepdim=True)
    want_dx, want_dw = ref.rmsnorm_bwd(x, w, dy)
    np.testing.assert_allclose(parts.sum(0).numpy(), want_dw.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), want_dx.numpy(), rtol=1e-4, atol=1e-5)
