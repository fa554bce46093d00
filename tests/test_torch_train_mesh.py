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
  its initial state, over :data:`DRAWS` draws.  The subprocess draws the
  parameters through a CRC-32 ``KeyGen`` (as ``test_torch_lm.
  stable_keys()`` does), so every process draws the same ones.  The
  metrics within rtol 1e-5; the state is judged against an f64 run of the
  port's one-lane ``microbatches=4`` step (:func:`f64_steps`): over the
  draws, the port's mean rms distance from it is no more than
  :data:`F64_MULTIPLE` times the reference's.  An element whose gradient
  is small beside its leaf's moves its Adam step by the f32 rounding of
  either package, so a fixed atol on the state misses on some draws (4
  of 12 salted draws missed 2e-5), and one draw's worst element is noise:
  on draws 0-11 the worst elements lie 1.2e-6 to 2.0e-5 (the port) and
  2.2e-6 to 1.3e-4 (the reference) from f64, neither package's the larger
  on every draw; the rms distances 6.7e-9 to 5.1e-8 and 7.9e-9 to 3.0e-7
  (means 2.6e-8 and 5.3e-8).
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
* Refusals: a mesh naming an absent card.  (A model axis trains every
  family: ``tests/test_torch_train_tp.py`` and
  ``tests/test_torch_train_tp_families.py``.)
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
    state = make_train_state(model, 0, device="cpu")
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
    want = make_train_state(model, 3, compress=compress, device="cpu")
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
    one = make_train_state(model, 0, compress=compress, device="cpu")
    step = make_train_step(model, _tcfg(microbatches=lanes, compress_grads=compress))
    proc = TrainProcess(model, _tcfg(compress_grads=compress), mesh=_lanes(lanes))
    plain = make_train_state(model, 0, compress=compress, device="cpu")
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
    state = make_train_state(model, 0, device="cpu")
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
    one = make_train_state(model, 0, device="cpu")
    _, want = make_train_step(model, _tcfg())(one, batch)
    proc = TrainProcess(model, _tcfg(), mesh=_lanes(2))
    proc.init(make_train_state(model, 0, device="cpu"), batch)
    state, got = proc.launch(proc.state, batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    for (name, s), (_, t) in zip(tree_flatten(state), tree_flatten(one)):
        np.testing.assert_allclose(s.full().float().numpy(), t.float().numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)
    halves = [make_train_step(model, _tcfg())(make_train_state(model, 0, device="cpu"),
                                              {k: v[h] for k, v in batch.items()})[1]["loss"]
              for h in (slice(0, 4), slice(4, 8))]
    assert abs(float(sum(halves)) / 2 - float(want["loss"])) > 1e-3
    # lanes that count the same tokens: bit for bit the microbatch step
    batch["loss_mask"] = np.concatenate([mask[:4], mask[:4]])
    one = make_train_state(model, 0, device="cpu")
    _, want = make_train_step(model, _tcfg(microbatches=2))(one, batch)
    proc = TrainProcess(model, _tcfg(), mesh=_lanes(2)).init(make_train_state(model, 0, device="cpu"), batch)
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
    state = make_train_state(model, 2, device="cpu")
    placed = shard_state(state, to_named(state_pspecs(model, state), _lanes(2)))
    captured.state = {f"{n}/{k}": p for n, s in tree_flatten(placed)
                      for k, p in enumerate(s.pieces)}
    proc = TrainProcess(model, _tcfg(), mesh=_lanes(2)).init(placed, stream.batch_at(0))
    assert captured.events == ["capture"] and int(placed["opt"]["step"].pieces[0]) == 0
    eager = make_train_state(model, 2, device="cpu")
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


def test_a_mesh_naming_an_absent_card_raises():
    from repro_torch.core.app import NoMatchingDeviceError
    model = build_model(get_smoke("qwen3-14b"))
    mesh = Mesh([[torch.device("cuda", 7)], [torch.device("cuda", 7)]])
    with pytest.raises(NoMatchingDeviceError, match="not present"):
        TrainProcess(model, _tcfg(), mesh=mesh)


# ---------------------------------------------------------------------------
# against the JAX package's mesh step (four forced host devices)
# ---------------------------------------------------------------------------

#: the parameter draws (seeds of the CRC-32 ``KeyGen``) the JAX
#: comparisons run over
DRAWS = tuple(range(12))
#: over the draws, the port's worst distance from the f64 run may be this
#: multiple of the reference's
F64_MULTIPLE = 1.5

#: the JAX package's ``KeyGen`` with a CRC-32 of the name in place of the
#: salted ``hash`` (``test_torch_lm.stable_keys()``), for the subprocesses
STABLE_KEYS = r"""
import zlib
import jax
from repro.models import common as _common
_common.KeyGen.__call__ = lambda self, name: jax.random.fold_in(
    self.key, zlib.crc32(name.encode()) % (2 ** 31))
"""

_JAX_FOUR = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
""" + STABLE_KEYS + r"""
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

# an Auto (pod, data, model) mesh: jax.make_mesh's Explicit axes are
# refused by the reference's constrain, and its batch specs name "pod"
mesh = Mesh(np.array(jax.devices(), dtype=object).reshape(1, 4, 1), ("pod", "data", "model"))
tcfg = TrainConfig(opt=AdamWConfig(schedule=Schedule(kind="constant", base_lr=1e-3,
                                                     warmup_steps=0)))
stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=12, batch=8))
out = {}
for seed in map(int, sys.argv[2].split(",")):
    state = make_train_state(model, jax.random.key(seed))
    out.update({f"{seed}/init{k}": v for k, v in named(state).items()})
    proc = TrainProcess(model, tcfg, mesh).init(state, stream.batch_at(0))
    metrics = []
    for i in range(3):
        state, m = proc.launch(state, stream.batch_at(i))
        metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    out.update({f"{seed}/final{k}": v for k, v in named(state).items()})
    out[f"{seed}/metrics"] = np.array(metrics)
np.savez(sys.argv[1], **out)
"""


def run_jax(script, *args, timeout=600):
    """``script`` in a subprocess on the CPU (forced host devices as it
    sets them) with ``args``; its npz output as ``{name: array}``."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.npz")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, "-c", script, out, *map(str, args)], env=env,
                           capture_output=True, text=True, timeout=timeout)
        assert r.returncode == 0, r.stderr
        data = np.load(out)
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def jax_four():
    """The JAX package's initial qwen3-14b SMOKE state of each draw, its 3
    steps on a four-device mesh and their metrics, from a subprocess."""
    return run_jax(_JAX_FOUR, ",".join(map(str, DRAWS)))


def _of(named, prefix):
    return {k[len(prefix):]: v for k, v in named.items() if k.startswith(prefix)}


def f64_steps(arch, init, batches, microbatches=1, metrics=None):
    """The state after the port's one-lane step with ``microbatches`` runs
    ``batches`` in f64 from the reference's initial state ``init``
    (``{keystr: array}``): f64 parameters, master, m and v, every
    ``.float()`` of the model, the plain kernels and AdamW made
    ``.double()`` (the patch of ``test_torch_train.py::
    test_f32_gradients_are_as_close_to_f64_as_the_reference``), the
    microbatches' gradients averaged in f64.  ``{keystr: float64 array}``;
    with a list ``metrics``, each step's (loss, grad_norm) is appended to
    it."""
    from unittest import mock
    from repro_torch.core.arena import tree_unflatten
    from repro_torch.models.common import tree_map
    from repro_torch.optim import adamw_update
    from repro_torch.train.step import loss_and_grads
    model = build_model(get_smoke(arch).scaled(param_dtype="float64", dtype="float64"))
    params = tree_unflatten((n, torch.tensor(np.asarray(v, np.float64)))
                            for n, v in _of(init, "['params']").items())
    opt = {"master": tree_map(lambda p: p.clone(), params),
           "m": tree_map(torch.zeros_like, params), "v": tree_map(torch.zeros_like, params),
           "step": torch.zeros((), dtype=torch.int32)}
    ocfg = AdamWConfig(schedule=Schedule(**SCHED))
    with mock.patch.object(torch.Tensor, "float", torch.Tensor.double):
        for batch in batches:
            rows = len(batch["tokens"]) // microbatches
            grads, loss = None, 0.0
            for i in range(microbatches):
                part = {k: torch.from_numpy(np.ascontiguousarray(v[i * rows:(i + 1) * rows]))
                        for k, v in batch.items()}
                m, g = loss_and_grads(model, params, part)
                g = dict(tree_flatten(g))
                grads = g if grads is None else {n: grads[n] + g[n] for n in g}
                loss += float(m["loss"]) / microbatches
            grads = tree_unflatten((n, a / microbatches) for n, a in grads.items())
            norm = float(adamw_update(params, grads, opt, ocfg)[2]["grad_norm"])
            if metrics is not None:
                metrics.append((loss, norm))
    state = {"params": params, "opt": opt}
    return {n: t.numpy() for n, t in tree_flatten(state) if t.dtype == torch.float64}


def f64_distance(named, truth):
    """(worst element, rms) of the distance of a state's float leaves from
    the f64 run's."""
    diff = np.concatenate([(np.asarray(named[n], np.float64) - t).ravel()
                           for n, t in truth.items()])
    return float(np.abs(diff).max()), float(np.sqrt(np.mean(diff ** 2)))


def assert_as_close_to_f64(port, reference, what=""):
    """Over the draws (a list of :func:`f64_distance` pairs each), the
    port's mean rms distance from f64 is no more than
    :data:`F64_MULTIPLE` times the reference's.  The worst element, a
    heavy-tailed noise of Adam steps at near-zero gradients, is in the
    message, not judged."""
    p, r = np.array(port), np.array(reference)
    assert p[:, 1].mean() <= F64_MULTIPLE * r[:, 1].mean(), (what, port, reference)


@pytest.fixture
def one_thread():
    """One torch thread for a test of many SMOKE-size steps: its small
    products run faster so, and a loaded host's threads do not spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_four_lanes_match_the_jax_mesh_step(jax_four, one_thread):
    from repro_torch import interop
    cfg = get_smoke("qwen3-14b")
    model = build_model(cfg)
    stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=12, batch=8))
    batches = [stream.batch_at(i) for i in range(3)]
    port, reference = [], []
    for seed in DRAWS:
        init = _of(jax_four, f"{seed}/init")
        state = interop.train_state_from_reference(init, cfg, "cpu")
        proc = TrainProcess(model, _tcfg(), mesh=_lanes(4)).init(state, batches[0])
        for i, batch in enumerate(batches):
            placed, m = proc.launch(state, batch)
            got = [float(m[k]) for k in ("loss", "grad_norm", "lr")]
            np.testing.assert_allclose(got, jax_four[f"{seed}/metrics"][i], rtol=1e-5,
                                       err_msg=f"draw {seed} step {i}")
        truth = f64_steps("qwen3-14b", init, batches, microbatches=4)
        port.append(f64_distance({n: s.full().numpy() for n, s in tree_flatten(placed)}, truth))
        reference.append(f64_distance(_of(jax_four, f"{seed}/final"), truth))
    assert_as_close_to_f64(port, reference)


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
