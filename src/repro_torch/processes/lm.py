"""Autoregressive decode as Pipeline processes (mirrors ``repro/processes/lm.py``).

The model speaks nested dicts (parameters, the KV cache); the framework
speaks arena-backed :class:`Data`.  :class:`TreeCodec` flattens a tree into
named arena entries, named as the JAX package names them (its
``jax.tree_util.keystr`` paths, keys sorted), so the weights and decode
state layouts match the JAX package's entry for entry.

* **decode state as one persistent arena Data**: ``token`` (B, 1),
  ``positions`` (B,), ``active`` (B,) int32, plus every cache leaf.  It is
  spec-only and ``persistent``: it lives on the device only, never grows a
  host mirror, and the step writes it in place.
* :class:`PrefillProcess`: prompt -> fresh decode state, the cache filled
  in the output arena itself.  An encoder-decoder model (Whisper) also
  binds the ``frames`` port: the audio frames of each prompt.
* :class:`DecodeStep`: one greedy step over the whole batch, bound in place
  (``infile == outfile`` == the state handle).  Where the JAX package
  donates the state to XLA, the models write the arena views: the dense
  decoder its new K/V row at slot ``pos % cache_len`` (``index_copy_``
  with a device index; ``pos = positions.max()`` stays on the device),
  RWKV6 its shift vectors and WKV state (the ``wkv6`` kernel writes the
  state over itself), Zamba2 its Mamba2 conv windows and SSM states
  (copied into the views).  A step never copies the cache and the only host
  sync per step is the caller's (B, 1) token readback.  On the card the
  step is compiled: from its second launch on it replays one CUDA graph
  (:meth:`repro_torch.core.process.Process.launch`).
* :class:`CacheSplice` / :class:`SlotRelease`: continuous-batching
  admission and retirement, in place on the state.  They and the
  prefill stay eager on the card (``graphed = False``).

* :class:`WhisperEncode` / :class:`WhisperPrefill`: the encoder and the
  decoder prefill as two graph nodes joined on the ``enc`` edge, the fan-in
  prefill graph of :class:`DecodeSession` for encoder-decoder models.  The
  ``enc`` edge is internal: planned device-resident, it is never uploaded
  or read back.

* **slot strips**: launched under a mesh whose ``model`` axis m > 1
  (``LOGICAL_AXES["slot"] = "model"``), :class:`DecodeStep` decodes the
  B slots as m strips of B/m rows, strip i on device i of the mesh's
  first model group, at the one ``pos = positions.max()`` of every slot
  (the reference's exact ``pmax``).  A strip is rows [i B/m, (i+1) B/m)
  of the one state, so :class:`CacheSplice` and :class:`SlotRelease`
  write a slot into the strip that owns it.  Strips on the state's device
  run on views of its arena and share its one weights Data (one graph
  holds them all); a strip on another device runs on a copy of its rows
  and a replica of the weights made once on that device, and its rows
  are copied back (eager: a graph records one device's work).  Where the
  axis is trivial, m does not divide B or a cache leaf's slot axis is not
  known, the step is the one-device step, as the reference's is.

Weights and the spliced row reach ``apply`` as secondary input ports (by
port name in ``aux``), read live at each launch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.app import CLapp
from repro_torch.core.arena import spec_dtype
from repro_torch.core.data import Data, NDArray, TensorSpec
from repro_torch.core.graph import Pipeline
from repro_torch.core.process import Port, Process, ProfileParameters, current_compile_mesh
from repro_torch.launch.mesh import mesh_axis, model_axis_size
from repro_torch.models.common import tree_flatten, tree_map

STATE_KEYS = ("token", "positions", "active")


class TreeCodec:
    """Stable tree <-> named-array bridge for one tree structure; the same
    codec maps a batch-1 row cache and the batch-B cache."""

    def __init__(self, tree: Any, prefix: str = ""):
        paths = [p for p, _ in tree_flatten(tree)]
        self.names: Tuple[str, ...] = tuple(prefix + p for p in paths)
        it = iter(self.names)
        # the structure, as a tree of leaf names in flatten order
        self._names_tree = self._names_of(tree, it)

    @classmethod
    def _names_of(cls, tree: Any, it) -> Any:
        if isinstance(tree, dict):
            return {k: cls._names_of(tree[k], it) for k in sorted(tree)}
        return next(it)

    def flatten(self, tree: Any) -> Dict[str, Any]:
        leaves = [leaf for _, leaf in tree_flatten(tree)]
        if len(leaves) != len(self.names):
            raise ValueError(f"tree has {len(leaves)} leaves, codec expects {len(self.names)}")
        return dict(zip(self.names, leaves))

    def unflatten(self, named: Dict[str, Any]) -> Any:
        return tree_map(lambda n: named[n], self._names_tree)


def weights_data(params: Any, prefix: str = "w") -> Tuple[Data, TreeCodec]:
    """Flatten a parameter tree into one arena-backed Data (the ``weights``
    input of every decode process) plus its codec.

    Tensor leaves give a host-backed Data (uploaded when registered).
    :class:`TensorSpec` leaves (``model.param_specs()``) give a spec-only,
    device-only Data: registering it makes a zeroed arena on the device,
    which ``model.init_params(generator, out=codec.unflatten(
    data.device_views()))`` fills in place: full-size weights with no host
    blob and no second device copy."""
    codec = TreeCodec(params, prefix=prefix)
    named = codec.flatten(params)
    if all(isinstance(v, TensorSpec) for v in named.values()):
        data = Data.from_specs(named)
        data.persistent = True
        data.residency = "device"
    else:
        data = Data({n: NDArray(v) for n, v in named.items()})
    return data, codec


def decode_state_data(model, batch: int, max_len: int,
                      enc_len: Optional[int] = None) -> Tuple[Data, TreeCodec]:
    """Spec-only persistent decode-state Data: sampling bookkeeping
    (``token``/``positions``/``active``) + every flattened cache leaf.  An
    encoder-decoder model's cache also holds the cross K/V of ``enc_len``
    encoder positions, which it then requires."""
    if model.cfg.family == "encdec":
        if enc_len is None:
            raise ValueError("encoder-decoder models need enc_len")
        cache = model.cache_specs(batch, max_len, enc_len)
    else:
        cache = model.cache_specs(batch, max_len)
    codec = TreeCodec(cache, prefix="cache")
    specs: Dict[str, TensorSpec] = {
        "token": TensorSpec((batch, 1), np.dtype(np.int32)),
        "positions": TensorSpec((batch,), np.dtype(np.int32)),
        "active": TensorSpec((batch,), np.dtype(np.int32)),
    }
    specs.update(codec.flatten(cache))
    state = Data.from_specs(specs)
    state.persistent = True
    state.residency = "device"
    return state, codec


def resolve_weights(model, weights: Any) -> Tuple[Data, TreeCodec]:
    """``weights`` as a (Data, codec) pair: a parameter tree is flattened
    with :func:`weights_data`; a Data (from :func:`weights_data` or
    :func:`repro_torch.interop.params_from_reference`) is checked against
    the model's parameter layout."""
    if not isinstance(weights, Data):
        return weights_data(weights)
    codec = TreeCodec(model.param_specs(), prefix="w")
    if tuple(weights.names) != codec.names:
        raise ValueError(f"weights Data entries {weights.names[:3]}... do not match the "
                         f"{model.cfg.name} parameter layout {codec.names[:3]}...")
    return weights, codec


def _target(views: Dict[str, torch.Tensor],
            out: Optional[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Where an in-place state process writes: the arena itself when the
    output views are the input views (bound in place), else the output
    arena after copying the input state into it, else fresh copies."""
    if out is None:
        return {k: v.clone() for k, v in views.items()}
    if all(out[k].data_ptr() == v.data_ptr() for k, v in views.items()):
        return views
    for k, v in views.items():
        out[k].copy_(v)
    return {k: out[k] for k in views}


class _LMProcess(Process):
    """Shared plumbing: model + weights/cache codecs.  ``init()`` loads every
    kernel module the model launches (its ``kernel_names``; built on a CUDA
    app), so a launch never compiles."""

    @property
    def kernel_names(self) -> Tuple[str, ...]:
        return self.model.kernel_names

    def __init__(self, app, model, wcodec: TreeCodec, ccodec: TreeCodec, *,
                 max_len: int, tag: str):
        super().__init__(app)
        self.model = model
        self.wcodec = wcodec
        self.ccodec = ccodec
        self.max_len = max_len
        self.set_launch_parameters((tag, repr(model.cfg), max_len))

    def _weights(self, aux):
        return self.wcodec.unflatten(aux["weights"])

    def _cache(self, out, b: int, device, enc_len: Optional[int] = None):
        """The cache to prefill: the output arena's views, reset, or fresh
        tensors when there is no output arena."""
        if out is not None:
            return self.model.reset_cache(self.ccodec.unflatten(out))
        if enc_len is None:
            return self.model.init_cache(b, self.max_len, device=device)
        return self.model.init_cache(b, self.max_len, enc_len, device=device)

    def _state(self, logits, cache, s: int):
        """Greedy-sample the prefill logits on the device and assemble the
        fresh state.  The returned leaves are the output views when the
        model wrote them in place; any other storage is copied in by the
        launch (pack_device)."""
        b, dev = logits.shape[0], logits.device
        state = {"token": logits.argmax(dim=-1).to(torch.int32),
                 "positions": torch.full((b,), s, dtype=torch.int32, device=dev),
                 "active": torch.ones((b,), dtype=torch.int32, device=dev)}
        state.update(self.ccodec.flatten(cache))
        return state


class PrefillProcess(_LMProcess):
    """Prompt tokens (B, S) -> fresh decode state: the cache is reset and
    prefilled in the output arena, and the greedy first token is sampled
    on the device.  Encoder-decoder models bind the ``frames`` port (the
    audio frames (B, T_enc, D)); the cache's cross K/V then cover T_enc
    encoder positions.

    Never captured into a CUDA graph: a server launches one prefill per
    prompt, and a graph of each repeated prompt length would keep its
    own memory pool at the prefill's activation peak for the server's
    life."""

    graphed = False

    ports = {"in": Port(names=("tokens",), dtype=np.integer, doc="prompt token ids (B, S)"),
             "frames": Port(optional=True, names=("frames",),
                            doc="audio frame embeddings (B, T_enc, D), encoder-decoder "
                                "families only"),
             "out": Port(names=STATE_KEYS),
             "weights": Port(doc="flattened model parameters")}

    def __init__(self, app, model, wcodec, ccodec, *, max_len: int):
        super().__init__(app, model, wcodec, ccodec, max_len=max_len, tag="prefill")

    def out_specs(self, in_specs, aux_specs=None):
        b = in_specs["tokens"].shape[0]
        frames = (aux_specs or {}).get("frames")
        enc_len = frames["frames"].shape[1] if frames is not None else None
        return decode_state_data(self.model, b, self.max_len, enc_len)[0].specs()

    def apply(self, views, aux, params, out=None):
        tokens = views["tokens"]
        b, s = tokens.shape
        w = self._weights(aux)
        if self.model.cfg.family == "encdec":
            if "frames" not in aux:
                raise ValueError("encoder-decoder prefill needs the 'frames' port bound")
            frames = aux["frames"]["frames"]
            cache = self._cache(out, b, tokens.device, frames.shape[1])
            logits, cache = self.model.prefill(w, frames, tokens, cache)
        else:
            logits, cache = self.model.prefill(w, tokens, self._cache(out, b, tokens.device))
        return self._state(logits, cache, s)


class WhisperEncode(Process):
    """Audio frames (B, T_enc, D) -> encoder states ``enc``, as a graph node
    of its own: the first half of the encoder -> decoder fan-in prefill.
    Its ``enc`` output edge is internal to the graph (device-resident).
    Eager on the card, as every prefill is."""

    graphed = False

    ports = {"in": Port(names=("frames",), doc="frame embeddings (B, T_enc, D)"),
             "out": Port(names=("enc",)),
             "weights": Port(doc="flattened model parameters")}

    def __init__(self, app, model, wcodec: TreeCodec):
        super().__init__(app)
        self.model = model
        self.wcodec = wcodec
        self.set_launch_parameters(("whisper_encode", repr(model.cfg)))

    @property
    def kernel_names(self) -> Tuple[str, ...]:
        return self.model.kernel_names

    def out_specs(self, in_specs, aux_specs=None):
        return {"enc": TensorSpec(tuple(in_specs["frames"].shape),
                                  spec_dtype(self.model.cfg.dtype))}

    def apply(self, views, aux, params, out=None):
        return {"enc": self.model.encode(self.wcodec.unflatten(aux["weights"]),
                                         views["frames"])}


class WhisperPrefill(_LMProcess):
    """Decoder-side prefill from encoder states: joins the ``enc`` edge of
    :class:`WhisperEncode`; the cross K/V computed from it land in the
    cache.  Eager on the card, as :class:`PrefillProcess`."""

    graphed = False

    ports = {"in": Port(names=("tokens",), dtype=np.integer, doc="prompt token ids (B, S)"),
             "enc": Port(names=("enc",), doc="encoder states (B, T_enc, D)"),
             "out": Port(names=STATE_KEYS),
             "weights": Port(doc="flattened model parameters")}

    def __init__(self, app, model, wcodec, ccodec, *, max_len: int):
        super().__init__(app, model, wcodec, ccodec, max_len=max_len, tag="whisper_prefill")

    def out_specs(self, in_specs, aux_specs=None):
        b = in_specs["tokens"].shape[0]
        enc_len = aux_specs["enc"]["enc"].shape[1]
        return decode_state_data(self.model, b, self.max_len, enc_len)[0].specs()

    def apply(self, views, aux, params, out=None):
        tokens = views["tokens"]
        b, s = tokens.shape
        enc = aux["enc"]["enc"]
        cache = self._cache(out, b, tokens.device, enc.shape[1])
        logits, cache = self.model.prefill_from_enc(self._weights(aux), enc, tokens, cache)
        return self._state(logits, cache, s)


class DecodeStep(_LMProcess):
    """One greedy decode step over the whole batch, in place on the state.

    Decodes every row at ``pos = positions.max()`` (inactive rows keep
    re-feeding their last token; the per-slot positions in the cache mask
    stale entries), then advances only the active rows: the JAX package's
    ``DecodeStep`` math.  Under a mesh whose ``model`` axis is larger than
    1 the slots are decoded in strips, one a device of the first model
    group (the module docstring); the tokens are the one-device step's."""

    ports = {"in": Port(names=STATE_KEYS), "out": Port(names=STATE_KEYS),
             "weights": Port(doc="flattened model parameters")}

    def __init__(self, app, model, wcodec, ccodec, *, max_len: int,
                 enc_len: Optional[int] = None):
        super().__init__(app, model, wcodec, ccodec, max_len=max_len, tag="decode_step")
        self.enc_len = enc_len
        #: weights copied to a strip device other than the state's, keyed
        #: by device, with the address of the weights they copy
        self._replicas: Dict[torch.device, Tuple[int, Any]] = {}
        self._axes: Dict[int, Dict[str, Optional[int]]] = {}

    def out_specs(self, in_specs, aux_specs=None):
        return dict(in_specs)

    def _slot_axes(self, b: int) -> Dict[str, Optional[int]]:
        """The slot axis of each cache leaf of a ``b``-slot state: the one
        axis on which the model's cache layout grows with the slot count
        (None where that is not one axis, or an encoder-decoder's
        ``enc_len`` is not known).  The reference guesses it instead (0
        where the leading axis is ``b``, else 1 where the next is), which
        agrees on every family but picks a stack axis of Zamba2's Mamba2
        state when the superblock count or the layers a superblock equal
        ``b`` (ROADMAP.md §3)."""
        if b not in self._axes:
            encdec = self.model.cfg.family == "encdec"
            axes: Dict[str, Optional[int]] = {}
            if not (encdec and self.enc_len is None):
                extra = (self.enc_len,) if encdec else ()
                one, two = (self.ccodec.flatten(self.model.cache_specs(n, self.max_len, *extra))
                            for n in (b, b + 1))
                for name, spec in one.items():
                    diff = [i for i, (x, y) in enumerate(zip(spec.shape, two[name].shape))
                            if x != y]
                    axes[name] = diff[0] if len(diff) == 1 else None
            self._axes[b] = axes
        return self._axes[b]

    def _step(self, w, state: Dict[str, torch.Tensor], pos) -> Dict[str, torch.Tensor]:
        token, positions, active = state["token"], state["positions"], state["active"]
        logits, cache = self.model.decode_step(w, token, pos, self.ccodec.unflatten(state))
        nxt = logits.argmax(dim=-1).to(torch.int32)               # (B, 1)
        token.copy_(torch.where(active[:, None] > 0, nxt, token))
        positions.add_(active)
        return self.ccodec.flatten(cache)

    def _weights_on(self, aux, device: torch.device):
        """The weights tree on ``device``: the weights Data's own views on
        its device, else a replica made once (again if the weights moved)."""
        w = self._weights(aux)
        first = next(iter(aux["weights"].values()))
        if first.device == device:
            return w
        held = self._replicas.get(device)
        if held is None or held[0] != first.data_ptr():
            held = self._replicas[device] = (first.data_ptr(), tree_map(
                lambda t: t.to(device, copy=True), w))
        return held[1]

    def apply(self, views, aux, params, out=None):
        state = _target(views, out)
        b = int(state["token"].shape[0])
        mesh = current_compile_mesh()
        m = model_axis_size(mesh) if mesh_axis("slot") == "model" else 1
        axes = self._slot_axes(b) if m > 1 and b % m == 0 else {}
        if any(axes.get(n) is None for n in state if n not in STATE_KEYS):
            # the models write their cache views in place; a leaf returned
            # as other storage is copied into the arena by the launch
            state.update(self._step(self._weights(aux), state, state["positions"].max()))
            return state
        axes = {**axes, **{k: 0 for k in STATE_KEYS}}
        pos = state["positions"].max()                  # over every slot: exact
        rows = b // m
        for i, dev in enumerate(mesh.groups[0]):
            strip = {n: t.narrow(axes[n], i * rows, rows) for n, t in state.items()}
            here = {n: (t if dev == t.device else t.to(dev)) for n, t in strip.items()}
            new = self._step(self._weights_on(aux, dev), here, pos.to(dev))
            for n, t in strip.items():
                src = new.get(n, here[n])
                if src.data_ptr() != t.data_ptr() or src.device != t.device:
                    t.copy_(src)
        return state


def _splice_row(full: torch.Tensor, row: torch.Tensor, slot: int) -> torch.Tensor:
    """Write a 1-row leaf into slot ``slot`` of the batched leaf, in place.
    The slot axis is the one axis on which the two shapes differ: 0 for the
    bookkeeping arrays and per-row leaves (deepseek's unstacked ``layer0``
    cache, (B, T, r)), 1 for stacked-layer (L, B, ...) leaves, 2 for
    Zamba2's doubly stacked (n_super, per_super, B, ...) Mamba2 state.  A
    one-slot state (leaf and row of one shape) takes the whole row.

    The JAX package's ``_splice_row`` guesses the axis instead (0 where the
    leading axes differ, else 1); it gives the same axis for every leaf of
    the other families, and writes Zamba2's rows into slot 0 (ROADMAP
    §3)."""
    if full.shape == row.shape:
        return full.copy_(row)
    axes = [i for i, (a, b) in enumerate(zip(full.shape, row.shape)) if a != b]
    if full.ndim != row.ndim or len(axes) != 1 or row.shape[axes[0]] != 1:
        raise ValueError(f"a row of shape {tuple(row.shape)} does not fit a slot of a "
                         f"leaf of shape {tuple(full.shape)}")
    full.narrow(axes[0], slot, 1).copy_(row)
    return full


class CacheSplice(Process):
    """Continuous-batching admission: splice a single-row prefilled state
    (the ``row`` input, batch 1) into slot ``slot`` of the batched state,
    in place (under a mesh's model axis, into the decode strip that owns
    the slot: its rows are the state's).  ``slot`` is a launch parameter.
    Never captured: it runs once per admission, a few copy kernels, and on
    an H100 its capture pays for itself only after 9-52 admissions of one
    slot (``launch/lm_step_profile.py``), more than a server run usually
    makes."""

    graphed = False

    ports = {"in": Port(names=STATE_KEYS), "out": Port(names=STATE_KEYS),
             "row": Port(doc="batch-1 state from a row prefill")}

    def __init__(self, app, slot: int = 0):
        super().__init__(app)
        self.set_slot(slot)

    def set_slot(self, slot: int) -> None:
        self.set_launch_parameters(("cache_splice", int(slot)))

    def out_specs(self, in_specs, aux_specs=None):
        return dict(in_specs)

    def apply(self, views, aux, params, out=None):
        slot = int(params[1])
        row = aux["row"]
        return {name: _splice_row(full, row[name], slot)
                for name, full in _target(views, out).items()}


class SlotRelease(Process):
    """Retire slot ``slot``: zero its ``active`` flag on the device
    (freezing its position and token), in place on the state.  One
    kernel a retirement, never captured: its capture pays for itself
    after 4-5 releases of one slot and then saves 0.3 ms a release (H100,
    ``launch/lm_step_profile.py``)."""

    graphed = False

    ports = {"in": Port(names=STATE_KEYS), "out": Port(names=STATE_KEYS)}

    def __init__(self, app, slot: int = 0):
        super().__init__(app)
        self.set_slot(slot)

    def set_slot(self, slot: int) -> None:
        self.set_launch_parameters(("slot_release", int(slot)))

    def out_specs(self, in_specs, aux_specs=None):
        return dict(in_specs)

    def apply(self, views, aux, params, out=None):
        state = _target(views, out)
        state["active"].narrow(0, int(params[1]), 1).zero_()
        return state


class DecodeSession:
    """Full-batch decode through the Pipeline stack: one prefill graph
    writing the persistent state (for an encoder-decoder model the fan-in
    graph ``frames`` -> :class:`WhisperEncode` ~ ``tokens`` ->
    :class:`WhisperPrefill`, joined on the device-resident ``enc`` edge),
    then one in-place :class:`DecodeStep` launched per token (on the card,
    replayed from one CUDA graph from the second step on).  ``step()``
    reads back only the (B, 1) token view; per-slot continuous batching is
    :class:`repro_torch.serve.LMServer`."""

    def __init__(self, app: CLapp, model, weights: Any, *, batch: int, max_len: int,
                 enc_len: Optional[int] = None):
        self.app = app
        self.model = model
        self.batch = batch
        self.max_len = max_len
        self.encdec = model.cfg.family == "encdec"
        wdata, self.wcodec = resolve_weights(model, weights)
        self.weights_h = app.addData(wdata)
        self.state, self.ccodec = decode_state_data(model, batch, max_len, enc_len)
        self.state_h = app.addData(self.state, to_device=False)
        if self.encdec:
            encode = WhisperEncode(app, model, self.wcodec).bind(
                infile="frames", outfile="enc", weights=self.weights_h)
            prefill = WhisperPrefill(app, model, self.wcodec, self.ccodec, max_len=max_len).bind(
                infile="tokens", outfile=self.state_h, enc="enc", weights=self.weights_h)
            self.prefill_pipe = Pipeline.from_graph(app, [encode, prefill])
        else:
            self.prefill_pipe = Pipeline(app) | PrefillProcess(
                app, model, self.wcodec, self.ccodec, max_len=max_len).bind(
                    infile="tokens", outfile=self.state_h, weights=self.weights_h)
        self.decode_pipe = Pipeline(app) | DecodeStep(
            app, model, self.wcodec, self.ccodec, max_len=max_len, enc_len=enc_len).bind(
                infile=self.state_h, outfile=self.state_h, weights=self.weights_h)

    def tokens(self) -> np.ndarray:
        """Device -> host copy of the (B, 1) current-token view."""
        return self.state.device_view("token").cpu().numpy()

    def prefill(self, tokens: np.ndarray, frames: Optional[np.ndarray] = None,
                profile: Optional[ProfileParameters] = None) -> np.ndarray:
        """Prefill the whole batch (with its audio ``frames`` (B, T_enc, D)
        for an encoder-decoder model); returns the greedy first tokens
        (B, 1)."""
        inputs: Any = Data({"tokens": np.asarray(tokens, np.int32)})
        if self.encdec:
            inputs = {"tokens": inputs, "frames": Data({"frames": np.asarray(frames, np.float32)})}
        self.prefill_pipe.run(inputs, sync=False, profile=profile)
        return self.tokens()

    def step(self, profile: Optional[ProfileParameters] = None) -> np.ndarray:
        """One batched decode step (in place, device-resident); returns the
        new (B, 1) tokens."""
        self.decode_pipe.run(None, sync=False, profile=profile)
        return self.tokens()
