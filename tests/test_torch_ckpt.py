"""The port's checkpoints (``repro_torch.ckpt``) against the JAX package's
(``repro.ckpt``) on the CPU: both formats (legacy ``state.arena`` +
``layout.json``, and ``sharded-v1``: ``host.arena`` + ``manifest.json``)
written by either package restore in the other, bf16 leaves included, and
the same state gives the same files byte for byte; a ``sharded-v1``
checkpoint the JAX package wrote on a mesh of 4 devices (its leaves cut
into ``shard_*.arena`` pieces) restores here.  That checkpoint is written
in a subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(forcing devices in this process would change the other tests' device
count).  Then the torn-write rules: a missing or truncated piece raises
``CheckpointCorruptError``, ``latest_step`` skips a step without its
manifest, ``keep_last`` and the ``.tmp`` litter, shape mismatches, an
asynchronous failure raised on ``wait()``.  All comparisons are exact."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.core import arena as jarena
from repro_torch.ckpt import (CheckpointCorruptError, CheckpointManager, cleanup, latest_step,
                              restore_checkpoint, save_checkpoint)
from repro_torch.core.arena import pack_tree_host, tree_flatten, unpack_tree_host

ROOT = Path(__file__).resolve().parents[1]
FORMATS = {"legacy": False, "sharded-v1": True}


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"embed": rng.standard_normal((5, 4)).astype(np.float32),
                       "layers": {"w": rng.standard_normal((2, 4, 3)).astype(np.float32)}},
            "opt": {"m": rng.standard_normal((5, 4)).astype(np.float32),
                    "step": np.int32(seed + 3)}}


def _port_state(seed=0):
    """The arrays as port tensors, ``params`` in bf16."""
    a = _arrays(seed)

    def conv(tree, path=""):
        if isinstance(tree, dict):
            return {k: conv(v, path + k) for k, v in tree.items()}
        t = torch.tensor(tree)
        return t.to(torch.bfloat16) if path.startswith("params") else t
    return conv(a)


def _jax_state(seed=0):
    a = _arrays(seed)
    return {"params": jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), a["params"]),
            "opt": jax.tree.map(jnp.asarray, a["opt"])}


def _bits(x):
    """A leaf's raw bytes (bf16 as its bit pattern) and dtype name."""
    if isinstance(x, torch.Tensor):
        name = "bfloat16" if x.dtype == torch.bfloat16 else str(x.dtype).removeprefix("torch.")
        t = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return t.numpy().tobytes(), name, tuple(x.shape)
    a = np.asarray(x)
    return a.tobytes(), a.dtype.name, a.shape


def _assert_same_leaves(port_tree, jax_tree):
    jflat = {jax.tree_util.keystr(p): v
             for p, v in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    pflat = dict(tree_flatten(port_tree))
    assert set(pflat) == set(jflat)
    for name in pflat:
        assert _bits(pflat[name]) == _bits(jflat[name]), name


def _files(path):
    return {p.name: p.read_bytes() for p in sorted(Path(path).iterdir())}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_port_checkpoint_round_trips(tmp_path, fmt):
    state = _port_state()
    save_checkpoint(str(tmp_path), 7, state, sharded=FORMATS[fmt])
    assert latest_step(str(tmp_path)) == 7
    like = {"params": {"embed": torch.zeros(5, 4), "layers": {"w": torch.zeros(2, 4, 3)}},
            "opt": {"m": torch.zeros(5, 4), "step": torch.zeros((), dtype=torch.int32)}}
    back = restore_checkpoint(str(tmp_path), like)
    for (n, a), (_, b) in zip(tree_flatten(back), tree_flatten(state)):
        assert a.dtype == b.dtype and torch.equal(a, b), n


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_both_packages_write_the_same_files(tmp_path, fmt):
    pp = save_checkpoint(str(tmp_path / "port"), 3, _port_state(), sharded=FORMATS[fmt])
    jp = jckpt.save_checkpoint(str(tmp_path / "jax"), 3, _jax_state(), sharded=FORMATS[fmt])
    port, ref = _files(pp), _files(jp)
    assert sorted(port) == sorted(ref) == (["host.arena", "manifest.json"] if FORMATS[fmt]
                                          else ["layout.json", "state.arena"])
    assert port == ref


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_port_checkpoint_restores_in_the_reference(tmp_path, fmt):
    save_checkpoint(str(tmp_path), 4, _port_state(1), sharded=FORMATS[fmt])
    assert jckpt.latest_step(str(tmp_path)) == 4
    back = jckpt.restore_checkpoint(str(tmp_path), _jax_state(0))
    _assert_same_leaves(_port_state(1), back)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_reference_checkpoint_restores_in_the_port(tmp_path, fmt):
    jckpt.save_checkpoint(str(tmp_path), 9, _jax_state(2), sharded=FORMATS[fmt])
    back = restore_checkpoint(str(tmp_path), _port_state(0))
    _assert_same_leaves(back, _jax_state(2))
    assert back["params"]["embed"].dtype == torch.bfloat16


_MESH_WRITER = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.ckpt import save_checkpoint
    assert len(jax.devices()) == 4
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    rng = np.random.default_rng(7)
    w = rng.standard_normal((8, 6)).astype(np.float32)
    e = rng.standard_normal((4, 10)).astype(np.float32)
    r = rng.standard_normal((3,)).astype(np.float32)
    put = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    state = {"params": {"w": put(w, P("data", "model")),
                        "e": put(jnp.asarray(e, jnp.bfloat16), P(None, "model")),
                        "r": put(r, P())},
             "opt": {"step": put(np.int32(5), P())}}
    save_checkpoint(sys.argv[1], 3, state, sharded=True)
""")


def test_reference_mesh_checkpoint_of_several_pieces_restores_in_the_port(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _MESH_WRITER, str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    step_dir = tmp_path / "step_0000000003"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    assert manifest["mesh"]["shape"] == [2, 2]
    assert len(manifest["shards"]) == 4
    assert {p["name"] for s in manifest["shards"] for p in s["pieces"]} == {
        "['params']['w']", "['params']['e']"}
    like = {"params": {"w": torch.zeros(8, 6), "e": torch.zeros(4, 10, dtype=torch.bfloat16),
                       "r": torch.zeros(3)}, "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    back = restore_checkpoint(str(tmp_path), like)
    rng = np.random.default_rng(7)
    w = rng.standard_normal((8, 6)).astype(np.float32)
    e = rng.standard_normal((4, 10)).astype(np.float32)
    r_ = rng.standard_normal((3,)).astype(np.float32)
    np.testing.assert_array_equal(back["params"]["w"].numpy(), w)
    assert back["params"]["e"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["params"]["e"].view(torch.int16).numpy(),
                                  np.asarray(jnp.asarray(e, jnp.bfloat16)).view(np.int16))
    np.testing.assert_array_equal(back["params"]["r"].numpy(), r_)
    assert int(back["opt"]["step"]) == 5


def test_pack_tree_host_matches_reference():
    blob, layout = pack_tree_host(_port_state())
    jblob, jlayout = jarena.pack_tree_host(_jax_state())
    assert layout.to_json() == jlayout.to_json()
    assert blob.tobytes() == np.asarray(jblob).tobytes()
    back = unpack_tree_host(blob, layout, _port_state())
    assert back["params"]["embed"].dtype == np.uint16     # bf16 as its bits
    assert back["params"]["embed"].tobytes() == _bits(_port_state()["params"]["embed"])[0]
    assert int(back["opt"]["step"]) == 3


def test_missing_or_truncated_piece_raises(tmp_path):
    path = Path(save_checkpoint(str(tmp_path), 2, _port_state(), sharded=True))
    host = path / "host.arena"
    data = host.read_bytes()
    host.write_bytes(data[:-8])
    with pytest.raises(CheckpointCorruptError, match="truncated") as err:
        restore_checkpoint(str(tmp_path), _port_state(), step=2)
    assert err.value.step == 2 and err.value.piece.startswith("host.arena")
    host.unlink()
    with pytest.raises(CheckpointCorruptError) as err:
        restore_checkpoint(str(tmp_path), _port_state(), step=2)
    assert err.value.piece == "host.arena"
    assert latest_step(str(tmp_path)) is None


def test_legacy_missing_blob_or_leaf_raises(tmp_path):
    path = Path(save_checkpoint(str(tmp_path), 1, _port_state()))
    like = _port_state()
    like["opt"]["v"] = torch.zeros(2)
    with pytest.raises(CheckpointCorruptError, match="not in checkpoint layout"):
        restore_checkpoint(str(tmp_path), like)
    (path / "state.arena").unlink()
    with pytest.raises(CheckpointCorruptError) as err:
        restore_checkpoint(str(tmp_path), _port_state(), step=1)
    assert err.value.piece == "state.arena"


def test_latest_step_skips_a_step_without_its_manifest(tmp_path):
    save_checkpoint(str(tmp_path), 4, _port_state(), sharded=True)
    torn = Path(save_checkpoint(str(tmp_path), 8, _port_state(), sharded=True))
    (torn / "manifest.json").unlink()
    assert latest_step(str(tmp_path)) == 4
    assert jckpt.latest_step(str(tmp_path)) == 4
    back = restore_checkpoint(str(tmp_path), _port_state())
    assert int(back["opt"]["step"]) == 3


def test_keep_last_and_tmp_litter(tmp_path):
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), s, _port_state(), keep_last=2)
    (tmp_path / "step_0000000009.tmp").mkdir()
    cleanup(str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003", "step_0000000004"]
    assert latest_step(str(tmp_path)) == 4


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_shape_mismatch_is_refused(tmp_path, fmt):
    save_checkpoint(str(tmp_path), 1, _port_state(), sharded=FORMATS[fmt])
    like = _port_state()
    like["params"]["embed"] = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="ckpt shape"):
        restore_checkpoint(str(tmp_path), like)


def test_restore_onto_a_mesh_waits_for_the_multi_gpu_slice(tmp_path):
    """The multi-GPU slice came (the name is the refusal's this test
    replaced): ``shardings`` (a tree of placements; None leaves a leaf
    whole) cuts each restored leaf of either format into its pieces on
    the mesh's lanes; a shardings tree that does not match the state
    raises."""
    from repro_torch.launch.mesh import Sharded, make_data_mesh
    mesh = make_data_mesh([torch.device("cpu")] * 2)
    for step, sharded in enumerate(FORMATS.values(), start=1):
        save_checkpoint(str(tmp_path), step, _port_state(), sharded=sharded)
        like = _port_state()
        back = restore_checkpoint(str(tmp_path), like, step, shardings=_spec_tree(like, mesh))
        for (name, got), (_, want) in zip(tree_flatten(back), tree_flatten(_port_state())):
            if isinstance(got, Sharded):
                assert torch.equal(got.full(), want) and len(got.pieces) == 2, name
            else:
                assert torch.equal(got, want), name
        with pytest.raises(ValueError, match="shardings tree"):
            restore_checkpoint(str(tmp_path), like, step, shardings={"params": None})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _port_state())


def _spec_tree(like, mesh):
    """Rows over ``data`` where they split in two, else whole."""
    from repro_torch.core.arena import tree_unflatten
    from repro_torch.launch.mesh import Placement
    return tree_unflatten(
        (n, Placement(mesh, ("data",)) if t.ndim and t.shape[0] % 2 == 0 else None)
        for n, t in tree_flatten(like))


@pytest.mark.parametrize("sharded", [False, True])
def test_manager_writes_asynchronously_from_a_snapshot(tmp_path, sharded):
    """The snapshot is taken before ``maybe_save`` returns: changing the
    state right after does not reach the file."""
    mgr = CheckpointManager(str(tmp_path), interval=2, keep_last=2, sharded=sharded)
    state = _port_state()
    assert not mgr.maybe_save(1, state)
    assert mgr.maybe_save(2, state)
    state["opt"]["m"].add_(1.0)
    mgr.wait()
    assert mgr.latest() == 2
    back = mgr.restore(_port_state())
    assert torch.equal(back["opt"]["m"], _port_state()["opt"]["m"])
    assert mgr.maybe_save(3, state, force=True)
    mgr.wait()
    assert mgr.latest() == 3
    assert torch.equal(mgr.restore(_port_state())["opt"]["m"], state["opt"]["m"])


def test_async_failure_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    mgr = CheckpointManager(str(blocker), interval=1)
    assert mgr.maybe_save(1, _port_state())
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        mgr.wait()
    mgr.wait()                     # the error is raised once
