"""The port's LM training across the data lanes of a mesh, against its own
one-lane step and the JAX package's mesh step.

* **Specs**: ``state_pspecs`` / ``batch_pspecs`` / ``zero1_spec`` equal
  the JAX package's for the SMOKE config of every architecture, leaf by
  leaf (a ``PartitionSpec`` compared as a tuple); ``to_named`` resolves
  the axes a mesh lacks as the JAX package's ``resolve_spec`` does.
* **Microbatch equality**: the step on 2, 4 and 8 CPU lanes
  (``make_data_mesh([cpu] * L)``, one CPU named L times) equals the
  one-lane step with ``microbatches=L`` bit for bit: every parameter
  replica, ``master``, ``m`` and ``v`` piece, the ``ef`` pieces, and the
  metrics; plain and with ``compress_grads``.
* **Against the JAX mesh**: qwen3-14b SMOKE on 4 lanes against the JAX
  package's ``TrainProcess`` on a ``(pod 1, data 4, model 1)`` mesh of
  four forced host devices (a subprocess under
  ``--xla_force_host_platform_device_count=4``, about 15 s), 3 steps from
  its initial state, within the training tests' band
  (``tests/test_torch_train.py``: metrics rtol 1e-5, state atol 2e-5).
* **A masked batch**: a ``loss_mask`` from a seed gives the lanes unequal
  token counts; the lanes are weighted by them, so the 2-lane step is the
  one-lane step over the whole batch (loss rtol 1e-6, state atol 2e-5, the
  training tests' band: an element whose gradient sits at the f32 gap of
  the two reduction orders moves its Adam step, measured 1e-6).
* ``dp_mean_compressed`` against the JAX function under ``jax.vmap(...,
  axis_name="data")`` over 2, 4 and 8 lanes and three seeds.
* ``Trainer(mesh=)``: a failure and a resume on the same 2 lanes equal an
  uninterrupted run bit for bit; a resume from 2 lanes onto 4 (and onto
  one device) within 1e-6 (the reduction order differs).
* Refusals: a training mesh with a model axis raises, naming ROADMAP
  item 6b; its specs are still computed.
"""
import os
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import build_model as j_build_model
from repro.models import common as jcommon
from repro.optim import compress as jcompress
from repro.train import make_train_state as j_make_train_state
from repro.train import step as jstep
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.core.arena import tree_flatten
from repro_torch.core.data import TensorSpec
from repro_torch.core.registry import launch_counts
from repro_torch.data.pipeline import StreamConfig, TokenStream
from repro_torch.launch.mesh import Mesh, Sharded, make_data_mesh
from repro_torch.models import build_model
from repro_torch.models.common import zero1_spec
from repro_torch.optim import AdamWConfig, Schedule
from repro_torch.optim.compress import dp_mean_compressed, ef_int8_compress
from repro_torch.train import (TrainConfig, Trainer, TrainerConfig, TrainProcess, batch_pspecs,
                               make_mesh_train_step, make_train_state, make_train_step,
                               shard_state, state_pspecs, to_named)
from test_torch_train import captured  # noqa: F401  (the capture recorder)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SCHED = dict(kind="constant", base_lr=1e-3, warmup_steps=0)
STREAMS = {"vlm": dict(kind="vlm"), "encdec": dict(kind="encdec", enc_frames=6)}


def _tcfg(**kw):
    return TrainConfig(opt=AdamWConfig(schedule=Schedule(**SCHED)), **kw)


def _stream(cfg, batch=8, seq=12):
    kw = dict(STREAMS.get(cfg.family, {}))
    if kw:
        kw.update(n_patches=cfg.n_patches, d_model=cfg.d_model)
    return TokenStream(StreamConfig(vocab=cfg.vocab, seq=seq, batch=batch, seed=0, **kw))


def _lanes(n):
    return make_data_mesh([CPU] * n)


def _spec_state(model, compress):
    """The port's train state as shapes (nothing allocated)."""
    specs = model.param_specs()
    state = {"params": specs, "opt": {"master": specs, "m": specs, "v": specs,
                                      "step": TensorSpec((), np.dtype(np.int32))}}
    if compress:
        state["ef"] = specs
    return state


def _j_specs(tree):
    return {jax.tree_util.keystr(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


def _assert_same_state(mesh_state, one, lanes):
    """Every piece of the mesh state equals the one-device state's slice,
    bit for bit."""
    for (name, s), (_, t) in zip(tree_flatten(mesh_state), tree_flatten(one)):
        for k in range(lanes):
            assert torch.equal(s.pieces[k], t[s.slices(k)]), (name, k)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_and_batch_specs_equal_the_jax_package(arch):
    jmodel, model = j_build_model(j_get_smoke(arch)), build_model(get_smoke(arch))
    jstate = jax.eval_shape(lambda: j_make_train_state(jmodel, jax.random.key(0), compress=True))
    want = _j_specs(jstep.state_pspecs(jmodel, jstate))
    got = dict(tree_flatten(state_pspecs(model, _spec_state(model, True))))
    assert set(got) == set(want)
    assert all(got[k] == want[k] for k in want), [k for k in want if got[k] != want[k]]
    cfg = get_smoke(arch)
    batch = _stream(cfg, batch=4, seq=8).batch_at(0)
    jbatch = jax.tree.map(np.asarray, batch)
    assert dict(tree_flatten(batch_pspecs(batch))) == _j_specs(jstep.batch_pspecs(jbatch))
    # against a (data, model) mesh the absent pod axis resolves away, as the
    # JAX package's resolve_spec resolves it
    mesh = make_data_mesh([CPU] * 4, model=2)
    with jcommon.mesh_axes(types.SimpleNamespace(axis_names=("data", "model"),
                                                 shape={"data": 2, "model": 2})):
        want_2d = {k: tuple(jcommon.resolve_spec(jax.sharding.PartitionSpec(*v)))
                   for k, v in _j_specs(jstep.batch_pspecs(jbatch)).items()}
    assert dict(tree_flatten(batch_pspecs(batch, mesh))) == want_2d
    named = dict(tree_flatten(to_named(batch_pspecs(batch), mesh)))
    assert {k: p.spec for k, p in named.items()} == want_2d
    assert all(p.mesh == mesh for p in named.values())


@pytest.mark.parametrize("spec,shape", [((), (32, 8)), (("model", None), (64, 32)),
                                        ((None, "model"), (48, 7)), ((), (5, 3)),
                                        (("model",), (16,)), ((None, None, "model"), (3, 16, 8))])
def test_zero1_spec_equals_the_jax_package(spec, shape):
    P = jax.sharding.PartitionSpec
    assert zero1_spec(spec, shape) == tuple(jcommon.zero1_spec(P(*spec), shape))


def test_to_named_places_a_state_in_its_zero1_pieces():
    """Parameters: one whole replica a lane; ``master``/``m``/``v``: cut over
    the data lanes on their first dim that 16 divides; a leaf 16 divides
    nowhere stays whole on every lane; ``step`` replicated."""
    cfg = get_smoke("qwen3-14b")
    model = build_model(cfg)
    state = make_train_state(model, 0)
    placed = shard_state(state, to_named(state_pspecs(model, state), _lanes(4)))
    emb = placed["params"]["embed"]["embedding"]
    assert isinstance(emb, Sharded) and emb.replicated and len(emb.pieces) == 4
    assert len({p.data_ptr() for p in emb.pieces}) == 4          # one copy a lane
    master = placed["opt"]["master"]["embed"]["embedding"]
    assert master.placement.spec == ("model", "data")          # model: size 1
    assert [tuple(p.shape) for p in master.pieces] == [(cfg.vocab, cfg.d_model // 4)] * 4
    assert torch.equal(master.full(), state["opt"]["master"]["embed"]["embedding"])
    assert placed["opt"]["step"].replicated
    odd = {name: s for name, s in tree_flatten(placed["opt"]["m"])
           if all(n % 16 for n in s.shape)}
    assert all(s.replicated for s in odd.values())


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compressed"])
@pytest.mark.parametrize("lanes", [2, 4])
def test_init_mesh_state_places_the_one_device_state_leaf_by_leaf(lanes, compress, monkeypatch):
    """``init_mesh_state`` is ``shard_state(make_train_state(...))`` bit
    for bit, made without the unplaced master and moments (neither
    ``adamw_init`` nor ``shard_state`` runs); its bytes are
    ``train_state_bytes``' state: a replica a lane and the f32 master, m,
    v (and ef) once over the lanes' pieces, up to the leaves 16 divides
    nowhere, which every lane holds whole."""
    from repro_torch.launch.train import train_state_bytes
    from repro_torch.train import init_mesh_state, step as step_mod
    cfg = get_smoke("qwen3-14b")
    model = build_model(cfg)
    mesh = _lanes(lanes)
    want = make_train_state(model, 3, compress=compress)
    want = shard_state(want, to_named(state_pspecs(model, want), mesh))

    def refused(*_a, **_k):
        raise AssertionError("the unplaced state was made")

    monkeypatch.setattr(step_mod, "adamw_init", refused)
    monkeypatch.setattr(step_mod, "shard_state", refused)
    got = init_mesh_state(model, 3, mesh, compress)
    assert [n for n, _ in tree_flatten(got)] == [n for n, _ in tree_flatten(want)]
    for (name, x), (_, y) in zip(tree_flatten(got), tree_flatten(want)):
        assert x.placement == y.placement and x.shape == y.shape, name
        assert all(torch.equal(p, q) and p.dtype == q.dtype for p, q in zip(x.pieces, y.pieces))
    n = sum(s.pieces[0].numel() for _, s in tree_flatten(got["params"]))
    itemsize = next(iter(tree_flatten(got["params"])))[1].pieces[0].element_size()
    whole = sum(s.pieces[0].numel() for _, s in tree_flatten(got["opt"]["m"]) if s.replicated)
    held = sum(p.numel() * p.element_size() for _, s in tree_flatten(got) for p in s.pieces)
    # the step's one lane of gradients and f32 sum are not held yet; ef,
    # the whole leaves' copies and the step counters are not counted
    counted = train_state_bytes(cfg, lanes) - n * (itemsize + 4)
    assert held == counted + compress * 4 * n + (3 + compress) * 4 * (lanes - 1) * whole \
        + 4 * lanes
    assert whole < n / 20


# ---------------------------------------------------------------------------
# the step over the lanes against the one-lane microbatch step
# ---------------------------------------------------------------------------

def _against_microbatches(arch, lanes, compress, steps=2):
    cfg = get_smoke(arch)
    model = build_model(cfg)
    stream = _stream(cfg)
    one = make_train_state(model, 0, compress=compress)
    step = make_train_step(model, _tcfg(microbatches=lanes, compress_grads=compress))
    proc = TrainProcess(model, _tcfg(compress_grads=compress), mesh=_lanes(lanes))
    plain = make_train_state(model, 0, compress=compress)
    proc.init(plain, stream.batch_at(0))
    for i in range(steps):
        one, want = step(one, stream.batch_at(i))
        state, got = proc.launch(plain, stream.batch_at(i))
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    assert state is proc.state
    _assert_same_state(state, one, lanes)
    assert int(state["opt"]["step"].pieces[-1]) == steps


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compressed"])
@pytest.mark.parametrize("lanes", [2, 4, 8])
def test_lanes_equal_the_microbatch_step_bit_for_bit(lanes, compress):
    _against_microbatches("qwen3-14b", lanes, compress)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "internvl2-2b", "rwkv6-3b",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_two_lanes_equal_two_microbatches_for_each_family(arch):
    _against_microbatches(arch, 2, False, steps=1)


def test_lane_rows_are_contiguous_in_lane_order():
    """Lane j trains on rows [j B/L, (j+1) B/L) of the global batch, as
    ``batch_pspecs`` places them."""
    cfg = get_smoke("qwen3-14b")
    model = build_model(cfg)
    seen = []
    loss_fn = model.loss_fn

    def recorded(params, batch):
        seen.append(batch["tokens"].clone())
        return loss_fn(params, batch)

    model.loss_fn = recorded
    batch = _stream(cfg).batch_at(0)
    mesh = _lanes(4)
    state = make_train_state(model, 0)
    step = make_mesh_train_step(model, _tcfg(), mesh)
    step(shard_state(state, to_named(state_pspecs(model, state), mesh)), batch)
    assert [tuple(t.shape) for t in seen] == [(2, 12)] * 4
    assert torch.equal(torch.cat(seen), torch.from_numpy(batch["tokens"]))
    with pytest.raises(ValueError, match="does not split"):
        step(shard_state(state, to_named(state_pspecs(model, state), mesh)),
             {k: v[:6] for k, v in batch.items()})


def test_masked_batch_weights_lanes_by_their_tokens():
    """A seeded ``loss_mask`` gives the two lanes 38 and 17 tokens: the
    2-lane step is the one-device step over the whole batch (its masked
    mean), and the lanes' unweighted mean would not be."""
    cfg = get_smoke("qwen3-14b")
    model = build_model(cfg)
    batch = dict(_stream(cfg).batch_at(0))
    rng = np.random.default_rng(5)
    mask = (rng.random((8, 12)) < np.repeat([0.8, 0.35], 4)[:, None]).astype(np.float32)
    batch["loss_mask"] = mask
    assert mask[:4].sum() != mask[4:].sum()
    one = make_train_state(model, 0)
    _, want = make_train_step(model, _tcfg())(one, batch)
    proc = TrainProcess(model, _tcfg(), mesh=_lanes(2))
    proc.init(make_train_state(model, 0), batch)
    state, got = proc.launch(proc.state, batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    for (name, s), (_, t) in zip(tree_flatten(state), tree_flatten(one)):
        np.testing.assert_allclose(s.full().float().numpy(), t.float().numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)
    halves = [make_train_step(model, _tcfg())(make_train_state(model, 0),
                                              {k: v[h] for k, v in batch.items()})[1]["loss"]
              for h in (slice(0, 4), slice(4, 8))]
    assert abs(float(sum(halves)) / 2 - float(want["loss"])) > 1e-3
    # lanes that count the same tokens: bit for bit the microbatch step
    batch["loss_mask"] = np.concatenate([mask[:4], mask[:4]])
    one = make_train_state(model, 0)
    _, want = make_train_step(model, _tcfg(microbatches=2))(one, batch)
    proc = TrainProcess(model, _tcfg(), mesh=_lanes(2)).init(make_train_state(model, 0), batch)
    state, got = proc.launch(proc.state, batch)
    assert all(torch.equal(got[k], want[k]) for k in want)
    _assert_same_state(state, one, 2)


def test_one_graph_holds_every_lane_of_one_device(captured):
    """As on the card: two lanes on one device make one capture, and each
    launch one replay of it (the recorder of ``tests/test_torch_train.py``
    in the capture seam), bit for bit the eager microbatch step."""
    cfg = get_smoke("qwen3-14b")
    model = build_model(cfg)
    stream = _stream(cfg)
    state = make_train_state(model, 2)
    placed = shard_state(state, to_named(state_pspecs(model, state), _lanes(2)))
    captured.state = {f"{n}/{k}": p for n, s in tree_flatten(placed)
                      for k, p in enumerate(s.pieces)}
    proc = TrainProcess(model, _tcfg(), mesh=_lanes(2)).init(placed, stream.batch_at(0))
    assert captured.events == ["capture"] and int(placed["opt"]["step"].pieces[0]) == 0
    eager = make_train_state(model, 2)
    step = make_train_step(model, _tcfg(microbatches=2))
    for i in range(3):
        out, metrics = proc.launch(placed, stream.batch_at(i))
        eager, want = step(eager, stream.batch_at(i))
        assert out is placed and torch.equal(metrics["loss"], want["loss"])
    assert (proc.captures, proc.replays) == (1, 3)
    assert captured.events == ["capture"] + ["replay"] * 3
    _assert_same_state(placed, eager, 2)
    per_step = {"rmsnorm": 2 * (4 * cfg.n_layers) + 1, "flash_attention": 2 * cfg.n_layers}
    counts = launch_counts()
    # init's warm-up (one lane), each replay's 2 lanes, the eager 2 microbatches
    assert {k: counts[k] for k in per_step} == {k: (1 + 3 * 2 + 3 * 2) * v
                                                for k, v in per_step.items()}


def test_a_training_mesh_with_a_model_axis_raises_naming_item_6b():
    cfg = get_smoke("qwen3-14b")
    model = build_model(cfg)
    mesh = make_data_mesh([CPU] * 4, model=2)
    for make in (lambda: TrainProcess(model, _tcfg(), mesh=mesh),
                 lambda: Trainer(model, TrainerConfig(), mesh=mesh),
                 lambda: make_mesh_train_step(model, _tcfg(), mesh)):
        with pytest.raises(NotImplementedError, match="6b"):
            make()
    # its specs and placements are still computed: Megatron pieces over model
    state = make_train_state(model, 0)
    placed = shard_state(state, to_named(state_pspecs(model, state), mesh))
    w_q = placed["params"]["layers"]["attn"]["w_q"]
    assert w_q.placement.spec == (None, None, "model")
    assert w_q.pieces[0].shape[-1] == state["params"]["layers"]["attn"]["w_q"].shape[-1] // 2
    assert torch.equal(w_q.full(), state["params"]["layers"]["attn"]["w_q"])


def test_a_mesh_naming_an_absent_card_raises():
    from repro_torch.core.app import NoMatchingDeviceError
    model = build_model(get_smoke("qwen3-14b"))
    mesh = Mesh([[torch.device("cuda", 7)], [torch.device("cuda", 7)]])
    with pytest.raises(NoMatchingDeviceError, match="not present"):
        TrainProcess(model, _tcfg(), mesh=mesh)


# ---------------------------------------------------------------------------
# against the JAX package's mesh step (four forced host devices)
# ---------------------------------------------------------------------------

_JAX_FOUR = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke
from repro.data.pipeline import StreamConfig, TokenStream
from repro.models import build_model
from repro.optim import AdamWConfig, Schedule
from repro.train import TrainConfig, TrainProcess, make_train_state
assert len(jax.devices()) == 4
cfg = get_smoke("qwen3-14b")
model = build_model(cfg)

def named(t):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}

state = make_train_state(model, jax.random.key(0))
out = {"init" + k: v for k, v in named(state).items()}
# an Auto (pod, data, model) mesh: jax.make_mesh's Explicit axes are
# refused by the reference's constrain, and its batch specs name "pod"
mesh = Mesh(np.array(jax.devices(), dtype=object).reshape(1, 4, 1), ("pod", "data", "model"))
tcfg = TrainConfig(opt=AdamWConfig(schedule=Schedule(kind="constant", base_lr=1e-3,
                                                     warmup_steps=0)))
stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=12, batch=8))
proc = TrainProcess(model, tcfg, mesh).init(state, stream.batch_at(0))
metrics = []
for i in range(3):
    state, m = proc.launch(state, stream.batch_at(i))
    metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
out.update({"final" + k: v for k, v in named(state).items()})
out["metrics"] = np.array(metrics)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_four(tmp_path_factory):
    """The JAX package's initial qwen3-14b SMOKE state, its 3 steps on a
    four-device mesh and their metrics, from a subprocess."""
    out = tmp_path_factory.mktemp("jax_four") / "out.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_FOUR, str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    data = np.load(out)
    return {k: data[k] for k in data.files}


def test_four_lanes_match_the_jax_mesh_step(jax_four):
    from repro_torch import interop
    cfg = get_smoke("qwen3-14b")
    model = build_model(cfg)
    init = {k[4:]: v for k, v in jax_four.items() if k.startswith("init")}
    state = interop.train_state_from_reference(init, cfg, "cpu")
    stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=12, batch=8))
    proc = TrainProcess(model, _tcfg(), mesh=_lanes(4)).init(state, stream.batch_at(0))
    for i in range(3):
        placed, m = proc.launch(state, stream.batch_at(i))
        got = [float(m[k]) for k in ("loss", "grad_norm", "lr")]
        np.testing.assert_allclose(got, jax_four["metrics"][i], rtol=1e-5, err_msg=f"step {i}")
    for name, s in tree_flatten(placed):
        want = jax_four["final" + name]
        for k in range(4):
            np.testing.assert_allclose(s.pieces[k].float().numpy(),
                                       want[s.slices(k)].astype(np.float32), rtol=0, atol=2e-5,
                                       err_msg=f"{name} lane {k}")


# ---------------------------------------------------------------------------
# dp_mean_compressed against the JAX function under vmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lanes", [2, 4, 8])
def test_dp_mean_compressed_matches_the_jax_package(lanes, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((lanes, 6, 40)).astype(np.float32) * rng.uniform(0.1, 10, lanes)[
        :, None, None].astype(np.float32)
    err = (rng.standard_normal((lanes, 6, 40)) * 1e-2).astype(np.float32)
    jmean, jerr = jax.vmap(lambda a, e: jcompress.dp_mean_compressed(a, e, "data"),
                           axis_name="data")(jnp.asarray(g), jnp.asarray(err))
    mean, new_err = dp_mean_compressed([torch.from_numpy(x) for x in g],
                                       [torch.from_numpy(x) for x in err])
    for j in range(lanes):
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean[j]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(new_err[j].numpy(), np.asarray(jerr[j]), rtol=0, atol=1e-7)
        q, scale, _ = ef_int8_compress(torch.from_numpy(g[j]), torch.from_numpy(err[j]))
        jq, jscale, _ = jcompress.ef_int8_compress(jnp.asarray(g[j]), jnp.asarray(err[j]))
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()
    with pytest.raises(ValueError, match="one of each"):
        dp_mean_compressed([torch.zeros(3)], [])


# ---------------------------------------------------------------------------
# Trainer(mesh=)
# ---------------------------------------------------------------------------

def _trainer(d, lanes, microbatches=1):
    cfg = TrainerConfig(total_steps=6, ckpt_dir=d, ckpt_interval=2, log_every=100,
                        train=_tcfg(microbatches=microbatches))
    mesh = _lanes(lanes) if lanes else None
    return Trainer(build_model(get_smoke("qwen3-14b")), cfg, mesh=mesh, device="cpu",
                   log_fn=lambda _m: None)


def test_trainer_resumes_onto_a_mesh_without_a_fresh_state(monkeypatch):
    """A resume onto the trainer's mesh restores from the state's layout:
    no fresh state is made beside the restored one."""
    from repro_torch.train import trainer as trainer_mod
    stream = _stream(get_smoke("qwen3-14b"))
    with tempfile.TemporaryDirectory() as d:
        want = _trainer(f"{d}/a", 2).fit(stream, 0)
        tr = _trainer(f"{d}/b", 2)
        with pytest.raises(RuntimeError, match="simulated"):
            tr.fit(stream, 0, simulate_failure_at=3)

        def refused(*_a, **_k):
            raise AssertionError("a fresh state was made before the restore")

        monkeypatch.setattr(trainer_mod, "init_mesh_state", refused)
        logs = []
        tr.log = logs.append
        got = tr.fit(stream, 0)
        assert "[trainer] resumed from checkpoint step 2" in logs
        for (name, x), (_, y) in zip(tree_flatten(want), tree_flatten(got)):
            assert all(torch.equal(p, q) for p, q in zip(x.pieces, y.pieces)), name


def _full(leaf):
    return leaf.full() if isinstance(leaf, Sharded) else leaf


def test_trainer_on_two_lanes_restarts_bit_for_bit_and_resumes_on_other_lane_counts():
    """A failure at step 3 resumed on the same 2 lanes ends bit for bit
    where an uninterrupted run does, which is where a one-device run with
    2 microbatches ends; a resume of the 2-lane checkpoint onto 4 lanes
    and onto one device ends within 1e-6 of it."""
    stream = _stream(get_smoke("qwen3-14b"))
    with tempfile.TemporaryDirectory() as d:
        a = _trainer(f"{d}/a", 2).fit(stream, 0)
        b = _trainer(f"{d}/b", 2).fit_with_restarts(stream, 0, failure_schedule=[3])
        for (name, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)):
            assert all(torch.equal(p, q) for p, q in zip(x.pieces, y.pieces)), name
        _assert_same_state(a, _trainer(f"{d}/one", 0, microbatches=2).fit(stream, 0), 2)
        for lanes in (4, 0):
            tr = _trainer(f"{d}/c{lanes}", 2)
            with pytest.raises(RuntimeError, match="simulated"):
                tr.fit(stream, 0, simulate_failure_at=3)
            c = _trainer(f"{d}/c{lanes}", lanes).fit(stream, 0)
            for (name, x), (_, y) in zip(tree_flatten(a), tree_flatten(c)):
                np.testing.assert_allclose(_full(y).float().numpy(), x.full().float().numpy(),
                                           rtol=0, atol=1e-6, err_msg=f"{name} onto {lanes}")
