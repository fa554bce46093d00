"""The port's LM serving and checkpoints across the lanes of a CPU mesh,
against its one-lane runs and the JAX package's forced-eight-device run.

* **Decode strips**: under a mesh with a ``model`` axis of m, the decode
  step decodes the B slots as m strips of B/m rows at the one ``pos`` of
  every slot.  A ``DecodeSession`` on an eight-lane CPU mesh with model
  axis 4 (``make_data_mesh([cpu] * 8, model=4)``) emits the one-lane
  session's tokens bit for bit for every family; ``LMServer`` on it
  equals the one-lane server, its admissions splicing into every strip;
  a slot count the axis does not divide runs the one-device step, as the
  reference's does.
* **Against the JAX package**: a subprocess under
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (about 25 s)
  runs ``tests/test_mesh_stream.py::test_decode_2d_bit_identical``'s
  setup (the port carries its parameters across; tokens bit for bit;
  the parameters drawn through a CRC-32 ``KeyGen``, as
  ``test_torch_lm.stable_keys()`` draws them, so every process draws the
  same ones),
  zamba2 with as many slots as superblocks on a (4, 2) mesh (where the
  reference's guessed slot axis picks a stack axis and its step fails to
  trace: the port's tokens are its one-device session's), writes a
  sharded checkpoint of a (2, 4) mesh state, and restores the port's
  multi-lane checkpoint onto its (2, 4) mesh.
* **Checkpoints**: the port's multi-lane save (one ``shard_NNNNN.arena`` a
  writing grid position, replicated leaves in ``host.arena``, the mesh in
  the manifest) is read by the JAX package's ``restore_checkpoint`` bit
  for bit, with no gather onto its (2, 4) mesh; the JAX (2, 4) checkpoint
  restores onto the port's (2, 4) lanes piece by piece (no ``"gather"``
  phase); elastic restores onto one lane and a (4, 2) mesh are bit for
  bit (and record ``"gather"``); torn steps are skipped.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as j_restore_checkpoint
from repro_torch import interop
from repro_torch.ckpt import (CheckpointCorruptError, CheckpointManager, latest_step,
                              restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_smoke
from repro_torch.core import CLapp, DeviceTraits, DeviceType, ProfileParameters
from repro_torch.launch.mesh import Placement, Sharded, make_data_mesh
from repro_torch.models import build_model
from repro_torch.models.common import ArchConfig
from repro_torch.processes.lm import DecodeSession
from repro_torch.serve import LMServer, SamplingConfig
from test_torch_compiled_launch import rec  # noqa: F401  (the recorder fixture)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ENC = 6                                   # whisper's encoder frames in these tests
CK_SPECS = {"rows": ("data",), "cols": (None, "model"), "rep": (), "bf": (("data", "model"),),
            "n": ()}


def _app(lanes=1, model=1):
    app = CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))
    if lanes > 1:
        app.set_mesh(make_data_mesh([CPU] * lanes, model=model))
    return app


def _rows_seen(model):
    """Record the rows of every decode-step call of ``model``."""
    seen = []
    step = model.decode_step

    def recorded(w, token, pos, cache):
        seen.append(int(token.shape[0]))
        return step(w, token, pos, cache)

    model.decode_step = recorded
    return seen


def _session_tokens(app, model, params, prompts, steps=6, frames=None):
    enc = frames.shape[1] if frames is not None else None
    sess = DecodeSession(app, model, params, batch=prompts.shape[0], max_len=32, enc_len=enc)
    toks = [sess.prefill(prompts, frames=frames).copy()]
    for _ in range(steps):
        toks.append(sess.step().copy())
    return np.concatenate(toks, 1)


# ---------------------------------------------------------------------------
# decode strips against the one-lane session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-14b", "h2o-danube-1.8b", "deepseek-v2-lite-16b",
                                  "granite-moe-1b-a400m", "internvl2-2b", "rwkv6-3b",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_decode_session_in_strips_equals_one_lane(arch):
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab, (4, 5)).astype(np.int32)
    frames = (rng.standard_normal((4, ENC, cfg.d_model)).astype(np.float32)
              if cfg.family == "encdec" else None)
    want = _session_tokens(_app(), model, params, prompts, frames=frames)
    seen = _rows_seen(model)
    got = _session_tokens(_app(8, 4), model, params, prompts, frames=frames)
    np.testing.assert_array_equal(got, want)
    assert seen == [1] * 4 * 6                     # 6 steps of 4 one-slot strips


def test_a_slot_count_the_axis_does_not_divide_runs_the_one_device_step():
    cfg = get_smoke("qwen3-14b")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (6, 4)).astype(np.int32)
    want = _session_tokens(_app(), model, params, prompts, steps=3)
    seen = _rows_seen(model)
    np.testing.assert_array_equal(_session_tokens(_app(8, 4), model, params, prompts, steps=3),
                                  want)
    assert seen == [6] * 3
    # a trivial model axis: the one-device step on eight data lanes
    seen.clear()
    _session_tokens(_app(8, 1), model, params, prompts[:4], steps=2)
    assert seen == [4] * 2


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-3b", "deepseek-v2-lite-16b"])
def test_lmserver_in_strips_equals_one_lane_with_splices_into_every_strip(arch):
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))

    def served(app):
        srv = LMServer(model, params, batch=4, max_len=32,
                       sampling=SamplingConfig(max_new_tokens=5), app=app)
        rng = np.random.default_rng(11)
        for _ in range(9):
            srv.submit(rng.integers(0, cfg.vocab, int(rng.integers(2, 9))).tolist())
        return srv, srv.run()

    _, want = served(_app())
    seen = _rows_seen(model)
    srv, got = served(_app(8, 4))
    assert got == want
    assert sorted(srv._splice) == [0, 1, 2, 3]          # a splice into every strip
    assert set(seen) == {1} and len(seen) == 4 * srv.steps


def test_lmserver_in_strips_captures_one_graph(rec):
    """Compiled as on the card (the recorder of
    ``tests/test_torch_compiled_launch.py``): every strip of one device is
    in the step's one capture, replayed each later step."""
    cfg = get_smoke("qwen3-14b")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    srv = LMServer(model, params, batch=4, max_len=32,
                   sampling=SamplingConfig(max_new_tokens=4), app=_app(8, 2))
    rng = np.random.default_rng(2)
    for _ in range(5):
        srv.submit(rng.integers(0, cfg.vocab, 6).tolist())
    seen = _rows_seen(model)
    got = srv.run()
    step = srv.decode_pipe.build().executor
    assert (step.captures, step.replays) == (1, srv.steps - 1)
    assert rec.events.count("capture") == 1
    # the eager first step and the capture run 2 strips of 2 rows; replays too
    assert set(seen) == {2} and len(seen) == 2 * (srv.steps + 1)
    assert all(len(r) == 4 for r in got)


# ---------------------------------------------------------------------------
# the JAX package on eight forced host devices
# ---------------------------------------------------------------------------

_JAX_EIGHT = r"""
import os, sys, zlib
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.ckpt import restore_checkpoint, save_checkpoint
from repro.configs import get_smoke
from repro.core import CLapp, DeviceTraits, ProfileParameters
from repro.models import build_model
from repro.models.common import ArchConfig
from repro.processes.lm import DecodeSession
from repro.models import common as _common
# the KeyGen with a CRC-32 of the name for the salted hash (as
# test_torch_lm.stable_keys()): every process draws the same parameters
_common.KeyGen.__call__ = lambda self, name: jax.random.fold_in(
    self.key, zlib.crc32(name.encode()) % (2 ** 31))
assert len(jax.devices()) == 8
d = sys.argv[1]
inp = np.load(f"{d}/in.npz")
out = {}

def named(t):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}

def drive(app, model, params, prompts, steps):
    sess = DecodeSession(app, model, params, batch=prompts.shape[0], max_len=32)
    sess.prefill(prompts)
    toks = [sess.tokens().copy()]
    for _ in range(steps):
        sess.step()
        toks.append(sess.tokens().copy())
    return np.concatenate(toks, 1)

# tests/test_mesh_stream.py::test_decode_2d_bit_identical's setup
cfg = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=16, n_heads=2, n_kv_heads=2,
                 d_ff=32, vocab=48, remat=False, dtype="float32", param_dtype="float32")
model = build_model(cfg)
params = model.init_params(jax.random.key(0))
out.update({"tiny" + k: v for k, v in named(params).items()})
out["tiny_one"] = drive(CLapp().init(device_traits=DeviceTraits(count=1)), model, params,
                        inp["tiny_prompts"], 5)
out["tiny_2d"] = drive(CLapp().init(model_axis=4), model, params, inp["tiny_prompts"], 5)
# zamba2 with as many slots as superblocks, on a (4, 2) mesh
zmodel = build_model(get_smoke("zamba2-2.7b"))
zparams = zmodel.init_params(jax.random.key(1))
out.update({"zamba" + k: v for k, v in named(zparams).items()})
out["zamba_one"] = drive(CLapp().init(device_traits=DeviceTraits(count=1)), zmodel, zparams,
                         inp["zamba_prompts"], 4)
try:        # the reference's guessed slot axis of the Mamba2 state is axis 0
    drive(CLapp().init(model_axis=2), zmodel, zparams, inp["zamba_prompts"], 4)
    out["zamba_2d_error"] = np.array("")
except ValueError as e:
    out["zamba_2d_error"] = np.array(str(e).splitlines()[0])
# a sharded checkpoint of a (2, 4) mesh state
app = CLapp().init(model_axis=4)
NS, P = jax.sharding.NamedSharding, jax.sharding.PartitionSpec
specs = {"rows": P("data"), "cols": P(None, "model"), "rep": P(),
         "bf": P(("data", "model"), None)}
host = {k: inp["ck_" + k] for k in specs}
host["bf"] = host["bf"].view(jax.numpy.bfloat16)
state = {k: jax.device_put(v, NS(app.mesh, specs[k])) for k, v in host.items()}
state["n"] = np.int32(41)
save_checkpoint(f"{d}/jax_ckpt", 3, state, sharded=True)
# the port's multi-lane checkpoint restored onto this (2, 4) mesh
prof = ProfileParameters(enable=True)
like = {k: np.zeros(v.shape, v.dtype) for k, v in host.items()}
like["n"] = np.int32(0)
shardings = {k: NS(app.mesh, s) for k, s in specs.items()}
shardings["n"] = None
back = restore_checkpoint(f"{d}/port_ckpt", like, shardings=shardings, profile=prof)
for k, v in back.items():
    a = np.asarray(v)
    out["port_" + k] = a.view(np.uint16) if a.dtype == jax.numpy.bfloat16 else a
out["port_gather"] = np.array("gather" in prof.phases)
out["port_devices"] = np.array([len(back[k].addressable_shards) for k in specs])
np.savez(f"{d}/out.npz", **out)
"""


def _ck_host(rng):
    """The checkpointed state: a leaf over data, one over model, one
    replicated, a bf16 one over both axes, an int32 scalar."""
    bf = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)).bfloat16()
    return {"rows": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
            "cols": torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32)),
            "rep": torch.from_numpy(rng.standard_normal((5,)).astype(np.float32)),
            "bf": bf, "n": torch.tensor(41, dtype=torch.int32)}


def _placed(host, mesh):
    return {k: Sharded.place(v, Placement(mesh, CK_SPECS[k])) for k, v in host.items()}


def _like(host):
    return {k: torch.zeros_like(v) for k, v in host.items()}


@pytest.fixture(scope="module")
def jax_eight(tmp_path_factory):
    """The inputs, the port's (2, 4) multi-lane checkpoint, and the
    forced-eight-device child's results."""
    d = tmp_path_factory.mktemp("jax_eight")
    rng = np.random.default_rng(7)
    tiny_prompts = np.asarray(rng.integers(0, 48, (4, 4)), np.int32)
    zamba_prompts = np.asarray(rng.integers(0, get_smoke("zamba2-2.7b").vocab, (2, 4)),
                               np.int32)
    host = _ck_host(np.random.default_rng(13))
    save_checkpoint(str(d / "port_ckpt"), 5, _placed(host, make_data_mesh([CPU] * 8, model=4)),
                    sharded=True)
    np.savez(d / "in.npz", tiny_prompts=tiny_prompts, zamba_prompts=zamba_prompts,
             **{"ck_" + k: (v.view(torch.int16).numpy().view(np.uint16) if k == "bf"
                            else v.numpy()) for k, v in host.items() if k != "n"})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_EIGHT, str(d)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    out = np.load(d / "out.npz")
    return {"dir": d, "host": host, "tiny_prompts": tiny_prompts,
            "zamba_prompts": zamba_prompts, **{k: out[k] for k in out.files}}


def test_decode_matches_the_jax_2d_session(jax_eight):
    """The reference's (2, 4) decode (one slot a model-group device) and
    the port's eight-lane mesh with model axis 4: the same tokens, bit for
    bit, both equal to each package's one-device session."""
    j = jax_eight
    cfg = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=16, n_heads=2,
                     n_kv_heads=2, d_ff=32, vocab=48, remat=False, dtype="float32",
                     param_dtype="float32")
    model = build_model(cfg)
    weights = interop.params_from_reference(
        {k[4:]: v for k, v in j.items() if k.startswith("tiny[")}, cfg, "cpu")
    np.testing.assert_array_equal(j["tiny_2d"], j["tiny_one"])
    for app in (_app(), _app(8, 4)):
        got = _session_tokens(app, model, weights, j["tiny_prompts"], steps=5)
        np.testing.assert_array_equal(got, j["tiny_one"])


def test_zamba2_with_as_many_slots_as_superblocks(jax_eight):
    """Two slots on a (4, 2) mesh: the port splits them on the Mamba2
    state's slot axis (2) and emits its one-device tokens, which are the
    JAX package's one-device tokens; the reference guesses axis 0 (the
    superblock axis, also 2 long), and its step fails to trace."""
    j = jax_eight
    cfg = get_smoke("zamba2-2.7b")
    assert cfg.n_layers // cfg.attn_every == 2
    model = build_model(cfg)
    weights = interop.params_from_reference(
        {k[5:]: v for k, v in j.items() if k.startswith("zamba[")}, cfg, "cpu")
    seen = _rows_seen(model)
    got = _session_tokens(_app(8, 2), model, weights, j["zamba_prompts"], steps=4)
    assert seen == [1] * 2 * 4
    np.testing.assert_array_equal(got, j["zamba_one"])
    assert "different leading axis sizes" in str(j["zamba_2d_error"])


# ---------------------------------------------------------------------------
# checkpoints from several lanes
# ---------------------------------------------------------------------------

def test_the_multi_lane_manifest(tmp_path):
    """Each unique piece once, from the first position that holds it,
    in ``shard_<grid position>.arena``; whole leaves in ``host.arena``."""
    import json
    host = _ck_host(np.random.default_rng(13))
    save_checkpoint(str(tmp_path), 1, _placed(host, make_data_mesh([CPU] * 8, model=4)),
                    sharded=True)
    with open(tmp_path / "step_0000000001" / "manifest.json") as f:
        man = json.load(f)
    assert man["mesh"] == {"axes": ["data", "model"], "shape": [2, 4]}
    pieces = {e["file"]: sorted(p["name"] for p in e["pieces"]) for e in man["shards"]}
    assert pieces == {"shard_00000.arena": ["['bf']", "['cols']", "['rows']"],
                      **{f"shard_0000{k}.arena": ["['bf']", "['cols']"] for k in (1, 2, 3)},
                      "shard_00004.arena": ["['bf']", "['rows']"],
                      **{f"shard_0000{k}.arena": ["['bf']"] for k in (5, 6, 7)}}
    assert [e["device_id"] for e in man["shards"]] == list(range(8))
    placement = {m["name"]: m["placement"] for m in man["leaves"]}
    assert placement == {"['bf']": "sharded", "['cols']": "sharded", "['n']": "host",
                         "['rep']": "host", "['rows']": "sharded"}


def test_the_port_multi_lane_checkpoint_is_read_by_the_jax_package(jax_eight):
    host = jax_eight["host"]
    named = j_restore_checkpoint(str(jax_eight["dir"] / "port_ckpt"),
                                 {k: np.zeros(tuple(v.shape), np.float32) for k, v in
                                  host.items()})
    for k, v in host.items():
        a = np.asarray(named[k])
        want = v.view(torch.int16).numpy() if k == "bf" else v.numpy()
        got = a.view(np.int16) if k == "bf" else a
        assert got.tobytes() == want.tobytes(), k
    # onto the reference's own (2, 4) mesh: piece by piece, no gather
    assert not bool(jax_eight["port_gather"])
    assert list(jax_eight["port_devices"]) == [8, 8, 8, 8]
    for k, v in host.items():
        want = v.view(torch.int16).numpy().view(np.uint16) if k == "bf" else v.numpy()
        assert jax_eight["port_" + k].tobytes() == want.tobytes(), k


def test_a_jax_2x4_checkpoint_restores_onto_the_port_lanes_piece_by_piece(jax_eight):
    host = jax_eight["host"]
    mesh = make_data_mesh([CPU] * 8, model=4)
    prof = ProfileParameters(enable=True)
    shardings = {k: Placement(mesh, s) for k, s in CK_SPECS.items()}
    back = restore_checkpoint(str(jax_eight["dir"] / "jax_ckpt"), _like(host),
                              shardings=shardings, profile=prof)
    assert "gather" not in prof.phases
    for k, v in host.items():
        s = back[k]
        assert isinstance(s, Sharded) and s.placement == shardings[k]
        for pos, piece in enumerate(s.pieces):
            assert torch.equal(piece, v[s.slices(pos)]), (k, pos)


@pytest.mark.parametrize("source", ["port", "jax"])
@pytest.mark.parametrize("target", ["one lane", "(4, 2)", "no placement"])
def test_elastic_restores_are_bit_for_bit(jax_eight, source, target):
    host = jax_eight["host"]
    path = str(jax_eight["dir"] / f"{source}_ckpt")
    prof = ProfileParameters(enable=True)
    if target == "no placement":
        back = restore_checkpoint(path, _like(host), profile=prof)
        assert all(torch.equal(back[k], v) for k, v in host.items())
    else:
        mesh = (make_data_mesh([CPU]) if target == "one lane"
                else make_data_mesh([CPU] * 8, model=2))
        back = restore_checkpoint(path, _like(host), profile=prof,
                                  shardings={k: Placement(mesh, s) for k, s in CK_SPECS.items()})
        for k, v in host.items():
            assert torch.equal(back[k].full(), v), k
            assert all(torch.equal(p, v[back[k].slices(i)]) for i, p in
                       enumerate(back[k].pieces)), k
    assert "gather" in prof.phases


def test_restore_takes_the_placements_of_a_sharded_state_like(tmp_path):
    mesh = make_data_mesh([CPU] * 4, model=2)
    host = _ck_host(np.random.default_rng(2))
    placed = _placed(host, mesh)
    save_checkpoint(str(tmp_path), 1, placed, sharded=True)
    like = _placed(_like(host), mesh)
    back = restore_checkpoint(str(tmp_path), like)
    for k, v in back.items():
        assert v.placement == like[k].placement and torch.equal(v.full(), host[k])
    # the legacy format of a placed state holds the whole leaves
    save_checkpoint(str(tmp_path), 2, placed)
    back = restore_checkpoint(str(tmp_path), like, step=2)
    assert all(torch.equal(back[k].full(), host[k]) for k in host)


def test_torn_multi_lane_steps_are_skipped(tmp_path):
    mesh = make_data_mesh([CPU] * 8, model=4)
    host = _ck_host(np.random.default_rng(4))
    save_checkpoint(str(tmp_path), 1, _placed(host, mesh), sharded=True)
    save_checkpoint(str(tmp_path), 2, _placed(host, mesh), sharded=True)
    os.remove(tmp_path / "step_0000000002" / "shard_00006.arena")
    assert latest_step(str(tmp_path)) == 1
    with pytest.raises(CheckpointCorruptError, match="shard_00006.arena") as err:
        restore_checkpoint(str(tmp_path), _like(host), step=2)
    assert err.value.step == 2
    back = restore_checkpoint(str(tmp_path), _like(host))
    assert all(torch.equal(back[k], v) for k, v in host.items())


def test_manager_writes_the_lanes_pieces_from_a_snapshot(tmp_path):
    """``CheckpointManager(sharded=True)`` copies each piece to the host
    before ``maybe_save`` returns: changing the pieces right after does
    not reach the files."""
    mesh = make_data_mesh([CPU] * 4, model=2)
    host = _ck_host(np.random.default_rng(6))
    placed = _placed(host, mesh)
    mgr = CheckpointManager(str(tmp_path), interval=1, sharded=True)
    assert mgr.maybe_save(1, placed)
    for s in placed.values():
        for p in s.pieces:
            p.fill_(7)
    mgr.wait()
    assert sorted(os.listdir(tmp_path / "step_0000000001"))[:2] == ["host.arena", "manifest.json"]
    back = mgr.restore(_like(host))
    assert all(torch.equal(back[k], v) for k, v in host.items())
