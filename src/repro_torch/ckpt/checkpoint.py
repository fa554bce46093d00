"""Arena-blob checkpoints: the paper's contiguous-layout idea applied to
fault tolerance.  Mirrors ``repro/ckpt/checkpoint.py``.

Two on-disk formats share one directory scheme (``step_NNNNNNNNNN/``), the
JAX package's byte for byte:

**Logical (legacy)**: ONE contiguous byte blob (``state.arena``, the packed
arena of every leaf of the train state, named by its key path) plus its
JSON offset table (``layout.json``): one sequential write and read.

**Sharded** (``save_checkpoint(..., sharded=True)``, format
``sharded-v1``): a ``manifest.json`` naming every piece, committed LAST,
so a partially written step is detectable: ``latest_step`` skips it and
``restore_checkpoint`` raises :class:`CheckpointCorruptError` naming the
step and the missing piece.  A whole leaf (a tensor, or a
:class:`~repro_torch.launch.mesh.Sharded` leaf every position holds
whole) goes to the one ``host.arena``; a leaf placed on a mesh in pieces
writes each piece once (a piece two positions hold: the first position
wins) into ``shard_NNNNN.arena``, ``NNNNN`` the writing position's place
in the grid (row-major; the JAX package numbers its files in device-id
order, and the port's mesh may name one device twice).  The manifest
records the mesh's axes and shape.  Each package reads the other's.

Restoring with ``shardings`` (a tree of
:class:`~repro_torch.launch.mesh.Placement`, e.g. ``to_named(state_pspecs
(...), mesh)``; or the placements of ``state_like``'s ``Sharded`` leaves)
returns ``Sharded`` leaves: when every position's piece was saved as it
is (the same mesh shape), each piece goes straight to its device; else
the leaf is assembled on the host from its pieces (the ``"gather"``
profile phase) and cut for the target: a restart onto another lane count.

Saving copies each leaf from the device to the host first (synchronously:
the caller may update the state in place right after), then writes;
``CheckpointManager`` writes on a worker thread, and a failed write is
raised by the next ``wait()``.  Without a placement, a restored leaf is a
tensor on the device of the matching leaf of ``state_like``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.arena import (ArenaLayout, dtype_name, np_dtype, pack_host,
                                    pack_tree_host, torch_dtype, tree_flatten, tree_unflatten,
                                    unpack_host)
from repro_torch.launch.mesh import Placement, Sharded, piece_index
from repro_torch.models.common import tree_map

_BLOB = "state.arena"
_META = "layout.json"
_MANIFEST = "manifest.json"
_HOST = "host.arena"
_FORMAT = "sharded-v1"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint step directory exists but is torn or incomplete.

    Carries the ``step`` and the name of the missing or invalid ``piece``
    (e.g. ``"manifest.json"``, ``"shard_00003.arena"``).  ``latest_step``
    never returns a torn step: this error means a step was asked for
    explicitly or the directory was damaged after listing."""

    def __init__(self, step: int, piece: str, detail: str = ""):
        self.step = step
        self.piece = piece
        msg = f"checkpoint step {step} is corrupt: missing or invalid {piece}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def _shard_file(k: int) -> str:
    return f"shard_{k:05d}.arena"


def _atomic_write(path: str, blob: np.ndarray) -> None:
    """A reader never sees a half-written blob under its final name (a
    crash leaves only ``*.tmp`` litter, reaped by :func:`cleanup`)."""
    blob.tofile(path + ".tmp")
    os.rename(path + ".tmp", path)


def _host_leaf(leaf: Any) -> Any:
    """A leaf copied to the host: a CPU tensor (bfloat16 stays bfloat16;
    a ``Sharded`` leaf assembled from its pieces), or a numpy array."""
    if isinstance(leaf, Sharded):
        return leaf.full("cpu")
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _host_state(state: Any) -> Any:
    return tree_map(_host_leaf, state)


def _index_slices(idx) -> Tuple[slice, ...]:
    return tuple(slice(a, b) for a, b in idx)


def _index_key(idx) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(a), int(b)) for a, b in idx)


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _sharded_save_plan(state: Any) -> Dict[str, Any]:
    """Snapshot ``state`` for a sharded save (the device-to-host copies
    happen here, synchronously): a whole leaf is one host entry; a leaf
    placed in pieces gives each unique piece to the first position that
    holds it (the JAX package's plan)."""
    host_arrays: Dict[str, Any] = {}
    leaves_meta: List[Dict[str, Any]] = []
    shard_data: Dict[int, Dict[str, Any]] = {}
    shard_pieces: Dict[int, List[Dict[str, Any]]] = {}
    mesh_info = None
    for name, leaf in tree_flatten(state):
        if isinstance(leaf, Sharded) and not leaf.replicated:
            if mesh_info is None:
                mesh_info = {"axes": list(leaf.mesh.axis_names),
                             "shape": [int(n) for n in leaf.mesh.devices.shape]}
            for k in leaf.unique():
                shard_data.setdefault(k, {})[name] = _host_leaf(leaf.pieces[k])
                shard_pieces.setdefault(k, []).append({"name": name, "index": leaf.index(k)})
            leaves_meta.append({"name": name, "shape": list(leaf.shape),
                                "dtype": dtype_name(leaf.dtype), "placement": "sharded"})
            continue
        if isinstance(leaf, Sharded):
            if mesh_info is None:
                mesh_info = {"axes": list(leaf.mesh.axis_names),
                             "shape": [int(n) for n in leaf.mesh.devices.shape]}
            leaf = leaf.pieces[0]                # replicated: one host copy
        host = _host_leaf(leaf)
        host_arrays[name] = host
        leaves_meta.append({"name": name, "shape": list(host.shape),
                            "dtype": dtype_name(host.dtype), "placement": "host"})
    return {"mesh": mesh_info, "leaves": leaves_meta, "host": host_arrays,
            "shards": shard_data, "pieces": shard_pieces}


def _write_sharded(directory: str, step: int, plan: Dict[str, Any],
                   keep_last: Optional[int], profile: Any = None) -> str:
    """One ``shard_NNNNN.arena`` a writing grid position, ``host.arena``,
    then the manifest, committed last."""
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    t0 = time.perf_counter()
    shard_entries = []
    for k in sorted(plan["shards"]):
        blob, layout = pack_host(plan["shards"][k])
        _atomic_write(os.path.join(tmp, _shard_file(k)), blob)
        shard_entries.append({"file": _shard_file(k), "bytes": int(blob.nbytes),
                              "device_id": k, "layout": json.loads(layout.to_json()),
                              "pieces": plan["pieces"][k]})
    host_entry = None
    if plan["host"]:
        hblob, hlayout = pack_host(plan["host"])
        _atomic_write(os.path.join(tmp, _HOST), hblob)
        host_entry = {"file": _HOST, "bytes": int(hblob.nbytes),
                      "layout": json.loads(hlayout.to_json())}
    manifest = {"format": _FORMAT, "step": step, "mesh": plan["mesh"],
                "leaves": plan["leaves"], "host": host_entry, "shards": shard_entries}
    mpath = os.path.join(tmp, _MANIFEST)
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(mpath + ".tmp", mpath)            # manifest committed LAST
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if profile is not None and getattr(profile, "enable", False):
        profile.record_phase("shard_write", time.perf_counter() - t0)
    if keep_last:
        cleanup(directory, keep_last)
    return final


def _write_legacy(directory: str, step: int, host_state: Any,
                  keep_last: Optional[int]) -> str:
    os.makedirs(directory, exist_ok=True)
    blob, layout = pack_tree_host(host_state)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, _META), "w") as f:
        f.write(layout.to_json())
    blob.tofile(os.path.join(tmp, _BLOB))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if keep_last:
        cleanup(directory, keep_last)
    return final


def save_checkpoint(directory: str, step: int, state: Any,
                    keep_last: Optional[int] = None, *,
                    sharded: bool = False, profile: Any = None) -> str:
    """Atomic save of a nested dict of tensors, ``Sharded`` leaves (a
    state placed on a mesh) or numpy arrays; returns the checkpoint's
    path.  ``sharded=False`` (legacy) copies every leaf whole to the host
    (the ``"gather"`` profile phase) and writes one logical arena blob;
    ``sharded=True`` writes the ``sharded-v1`` manifest format (each
    unique piece from the position that holds it, no gather), manifest
    last."""
    if sharded:
        return _write_sharded(directory, step, _sharded_save_plan(state), keep_last, profile)
    t0 = time.perf_counter()
    host_state = _host_state(state)
    if profile is not None and getattr(profile, "enable", False):
        profile.record_phase("gather", time.perf_counter() - t0)
    return _write_legacy(directory, step, host_state, keep_last)


# ---------------------------------------------------------------------------
# completeness / discovery
# ---------------------------------------------------------------------------

def _piece_missing(path: str, entry: Dict[str, Any]) -> Optional[str]:
    fp = os.path.join(path, entry["file"])
    if not os.path.exists(fp):
        return entry["file"]
    if os.path.getsize(fp) != entry["bytes"]:
        return (f"{entry['file']} (truncated: {os.path.getsize(fp)} of "
                f"{entry['bytes']} bytes)")
    return None


def _manifest_missing(path: str, manifest: Dict[str, Any]) -> Optional[str]:
    """Name of the first missing or size-mismatched piece, or None."""
    entries = list(manifest.get("shards", ()))
    if manifest.get("host"):
        entries.append(manifest["host"])
    for entry in entries:
        missing = _piece_missing(path, entry)
        if missing is not None:
            return missing
    return None


def _step_complete(path: str) -> bool:
    """True iff the step directory holds a fully committed checkpoint in
    either format: the torn-write detector behind :func:`latest_step`."""
    mpath = os.path.join(path, _MANIFEST)
    if os.path.exists(mpath):
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False
        return _manifest_missing(path, manifest) is None
    meta = os.path.join(path, _META)
    blob = os.path.join(path, _BLOB)
    if os.path.exists(meta) and os.path.exists(blob):
        try:
            with open(meta) as f:
                layout = ArenaLayout.from_json(f.read())
        except (OSError, ValueError, KeyError):
            return False
        return os.path.getsize(blob) == layout.total_bytes
    return False


def latest_step(directory: str) -> Optional[int]:
    """Newest COMPLETE step (torn or partial checkpoints are skipped, so a
    crash mid-save falls back to the last good one)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and _step_complete(os.path.join(directory, name)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def _host_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """Host bytes of ``dtype`` as a CPU tensor (a copy; 0-d stays 0-d)."""
    a = np.array(arr, order="C")
    if torch_dtype(dtype) == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _as_tensor(arr: np.ndarray, dtype: str, like: Any) -> torch.Tensor:
    """A restored leaf (host bytes of ``dtype``) as a tensor on the device
    of ``like`` (the CPU when it is no tensor)."""
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return _host_tensor(arr, dtype).to(device)


def _placements(state_like: Any, shardings: Any) -> Dict[str, Optional[Placement]]:
    """Each leaf's target placement: from ``shardings`` (a tree of
    ``Placement`` or None laid out as ``state_like``), else a ``Sharded``
    leaf's own."""
    flat = tree_flatten(state_like)
    if shardings is not None:
        given = dict(tree_flatten(shardings))
        if set(given) != {n for n, _ in flat}:
            raise ValueError(f"shardings tree has {len(given)} leaves, state has {len(flat)}")
        return given
    return {n: (leaf.placement if isinstance(leaf, Sharded) else None) for n, leaf in flat}


def _placed(arr: np.ndarray, dtype: str, like: Any, target: Optional[Placement]) -> Any:
    """A whole restored leaf on the device of ``like``, or cut for
    ``target``."""
    if target is None:
        return _as_tensor(arr, dtype, like)
    return Sharded.place(_host_tensor(arr, dtype), target)


def _check_shape(name: str, shape, like: Any) -> None:
    if tuple(shape) != tuple(np.shape(like)):
        raise ValueError(f"{name}: ckpt shape {tuple(shape)} != state {tuple(np.shape(like))}")


def _restore_legacy(path: str, step: int, state_like: Any, shardings: Any) -> Any:
    meta = os.path.join(path, _META)
    if not os.path.exists(meta):
        raise CheckpointCorruptError(step, _META)
    with open(meta) as f:
        layout = ArenaLayout.from_json(f.read())
    bp = os.path.join(path, _BLOB)
    if not os.path.exists(bp):
        raise CheckpointCorruptError(step, _BLOB)
    blob = np.fromfile(bp, dtype=np.uint8)
    if blob.nbytes != layout.total_bytes:
        raise CheckpointCorruptError(
            step, _BLOB, f"truncated: {blob.nbytes} of {layout.total_bytes} bytes")
    named = unpack_host(blob, layout)
    targets = _placements(state_like, shardings)
    out = {}
    for name, like in tree_flatten(state_like):
        if name not in layout.names:
            raise CheckpointCorruptError(step, f"leaf {name!r}", "not in checkpoint layout")
        arr = named[name]
        _check_shape(name, arr.shape, like)
        out[name] = _placed(arr, layout.entry(name).dtype, like, targets[name])
    return tree_unflatten(out.items())


def _restore_sharded(path: str, step: int, state_like: Any, shardings: Any,
                     profile: Any) -> Any:
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    missing = _manifest_missing(path, manifest)
    if missing is not None:
        raise CheckpointCorruptError(step, missing)

    blob_cache: Dict[str, Dict[str, np.ndarray]] = {}

    def named_of(entry: Dict[str, Any]) -> Dict[str, np.ndarray]:
        if entry["file"] not in blob_cache:
            blob = np.fromfile(os.path.join(path, entry["file"]), dtype=np.uint8)
            layout = ArenaLayout.from_json(json.dumps(entry["layout"]))
            blob_cache[entry["file"]] = unpack_host(blob, layout)
        return blob_cache[entry["file"]]

    host_named = named_of(manifest["host"]) if manifest.get("host") else {}
    pieces: Dict[str, List[Tuple[Any, Dict[str, Any]]]] = {}
    for se in manifest["shards"]:
        for p in se["pieces"]:
            pieces.setdefault(p["name"], []).append((p["index"], se))
    leaf_meta = {m["name"]: m for m in manifest["leaves"]}
    targets = _placements(state_like, shardings)

    out = {}
    t_gather = 0.0
    for name, like in tree_flatten(state_like):
        meta = leaf_meta.get(name)
        if meta is None:
            raise CheckpointCorruptError(step, f"leaf {name!r}", "not in manifest")
        _check_shape(name, meta["shape"], like)
        target = targets[name]
        if meta["placement"] == "host":
            arr = host_named.get(name)
            if arr is None:
                raise CheckpointCorruptError(step, f"leaf {name!r}", "not in host arena")
            out[name] = _placed(arr, meta["dtype"], like, target)
            continue
        plist = pieces.get(name, [])
        if not plist:
            raise CheckpointCorruptError(step, f"leaf {name!r}",
                                         "no shard pieces in manifest")
        if target is not None:
            # every target position's piece saved as it is: each goes
            # straight to its device, no logical array on the host
            by_idx = {_index_key(idx): se for idx, se in plist}
            shape = tuple(meta["shape"])
            wanted = [_index_key(piece_index(shape, target.spec, target.mesh, k))
                      for k in range(target.mesh.devices.size)]
            if all(key in by_idx for key in wanted):
                devs = target.mesh.devices.flat
                out[name] = Sharded(target, shape, [
                    _host_tensor(named_of(by_idx[key])[name], meta["dtype"]).to(devs[k])
                    for k, key in enumerate(wanted)])
                continue
        # the pieces assembled into the logical array on the host (another
        # mesh shape, or no placement)
        t0 = time.perf_counter()
        arr = np.zeros(tuple(meta["shape"]), np_dtype(meta["dtype"]))
        for idx, se in plist:
            arr[_index_slices(idx)] = named_of(se)[name]
        t_gather += time.perf_counter() - t0
        out[name] = _placed(arr, meta["dtype"], like, target)
    if t_gather and profile is not None and getattr(profile, "enable", False):
        profile.record_phase("gather", t_gather)
    return tree_unflatten(out.items())


def restore_checkpoint(directory: str, state_like: Any, step: Optional[int] = None,
                       shardings: Any = None, *, profile: Any = None) -> Any:
    """Restore a checkpoint of either format (written by either package)
    into a nested dict laid out as ``state_like``.  ``step`` defaults to
    :func:`latest_step`.  A leaf with a target placement (``shardings``,
    a tree of ``Placement``; or ``state_like``'s ``Sharded`` leaf) comes
    back ``Sharded``: piece by piece when the checkpoint holds the
    target's pieces, else assembled on the host and cut (the ``"gather"``
    phase); any other leaf is a tensor on the device of ``state_like``'s.
    Torn checkpoints raise :class:`CheckpointCorruptError` naming the step
    and the missing piece; a leaf whose shape differs from
    ``state_like``'s raises ``ValueError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoints in {directory}")
    path = _step_dir(directory, step)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{directory} has no checkpoint for step {step}")
    if os.path.exists(os.path.join(path, _MANIFEST)):
        return _restore_sharded(path, step, state_like, shardings, profile)
    return _restore_legacy(path, step, state_like, shardings)


def cleanup(directory: str, keep_last: int) -> None:
    """Drop all but the newest ``keep_last`` steps AND reap stale
    ``step_*.tmp`` litter left by a crashed writer."""
    steps = []
    for name in os.listdir(directory):
        if re.fullmatch(r"step_(\d+)\.tmp", name):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
            continue
        if (m := re.fullmatch(r"step_(\d+)", name)):
            steps.append(int(m.group(1)))
    for s in sorted(steps)[:-keep_last]:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


class CheckpointManager:
    """Asynchronous checkpoints for the train loop: ``maybe_save`` copies
    the state to the host synchronously (each unique piece of a state on
    a mesh with ``sharded=True``; the loop may update it in place right
    after) and writes on a worker thread; a failed write is raised
    by the next ``wait()`` (or ``maybe_save``, which waits first)."""

    def __init__(self, directory: str, interval: int = 100, keep_last: int = 3,
                 async_save: bool = True, sharded: bool = False):
        self.directory = directory
        self.interval = interval
        self.keep_last = keep_last
        self.async_save = async_save
        self.sharded = sharded
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def maybe_save(self, step: int, state: Any, force: bool = False) -> bool:
        if not force and (self.interval <= 0 or step % self.interval != 0):
            return False
        self.wait()
        if self.sharded:
            plan = _sharded_save_plan(state)                 # device -> host here

            def write():
                _write_sharded(self.directory, step, plan, self.keep_last)
        else:
            host_state = _host_state(state)                  # device -> host here

            def write():
                _write_legacy(self.directory, step, host_state, self.keep_last)

        def guarded():
            try:
                write()
            except BaseException as e:  # raised by the next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()
        else:
            guarded()
            self._raise_if_failed()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {err!r}") from err

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore(self, state_like: Any, shardings: Any = None,
                step: Optional[int] = None) -> Any:
        return restore_checkpoint(self.directory, state_like, step, shardings)
