"""Train-step factory: loss, gradient (microbatch accumulation), optional
int8 error-feedback compression, clip and AdamW.  Mirrors
``repro/train/step.py``.

``make_train_step`` returns the step as a plain function, ``(state,
batch) -> (state, metrics)``, that updates the state's tensors in place
(the reference's is pure and donates its input state).
:class:`TrainProcess` is the paper's init/launch split at training scale:
``init()`` captures the whole step (forward, backward, clip, AdamW) into
one CUDA graph, ``launch()`` copies the batch into the captured input and
replays it.

On a ``(data, model)`` mesh (``TrainProcess(mesh=)``, one process driving
every lane as the JAX package's single controller does) the state's leaves
are :class:`~repro_torch.launch.mesh.Sharded`: each parameter in the
pieces its partition rule gives the ``model`` axis (Megatron-style tensor
parallelism; a leaf the rules leave whole is replicated), one piece a grid
position, and the optimizer's master, m, v (and the error-feedback buffer)
cut further into their ZeRO-1 pieces over ``data`` (``state_pspecs`` /
``to_named`` / ``shard_state``, or ``init_mesh_state`` leaf by leaf).
Each data lane, a model group of M lanes, runs the forward and backward
of its contiguous rows of the global batch, each lane on its pieces
(:mod:`repro_torch.models.parallel`); the data lanes' gradients are
reduced in f32 in lane order by the one microbatch accumulation
(``accumulate_grads``), each model piece on its own lane of the first
group, so no lane holds a whole model-split gradient and an L-lane
data-only step equals the one-lane step with ``microbatches=L`` bit for
bit.  Each grid position updates its pieces with the whole gradient's
norm (each distinct piece counted once) and scalars, and its new
parameter piece is copied into every replica that shares its ``model``
coordinate.  Every family trains over a model axis larger than 1: the
decoder family (``DecoderLM``), rwkv6 (the WKV recurrence on a lane's
heads), zamba2 (the SSD on a lane's heads, the shared block as the
decoder's) and whisper (its cross attention over the lanes too).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import process as _process
from repro_torch.core import trace
from repro_torch.core.arena import tree_flatten, tree_unflatten
from repro_torch.core.data import TensorSpec
from repro_torch.core.registry import add_launches, counting_into
from repro_torch.launch.mesh import (Mesh, Placement, Sharded, check_present, model_axis_size,
                                     piece_index, resolve_spec)
from repro_torch.models.common import BATCH_AXES, partition_tree, tree_map, tree_paths, zero1_spec
from repro_torch.models import parallel as tp
from repro_torch.models.parallel import ModelGroup
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import adamw_scalars, update_leaf

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    compress_grads: bool = False   # int8 error feedback on the gradient
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def _generator(rng, device) -> torch.Generator:
    """A fresh generator on ``device`` for an int seed, or a copy of a
    generator's state (drawing from it leaves ``rng`` as it was), so that
    initialising twice from one ``rng`` gives the same parameters, as a
    JAX key does."""
    device = torch.device(device)
    if isinstance(rng, torch.Generator):
        g = torch.Generator(device=rng.device)
        g.set_state(rng.get_state())
        return g
    return torch.Generator(device=device).manual_seed(int(rng))


def default_device(device=None) -> torch.device:
    """``device``, or the card: the port's entry points run on the card
    unless the caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def make_train_state(model, rng, compress: bool = False, *, device=None) -> Dict[str, Any]:
    """{"params", "opt": {"master", "m", "v", "step"}[, "ef"]}: the
    reference's layout (and checkpoint leaf names), on ``device``, the
    card unless given (:func:`default_device`: with no CUDA device, pass
    ``device="cpu"``); ``rng`` an int seed or a ``torch.Generator`` on
    ``device``."""
    device = default_device(device)
    params = model.init_params(_generator(rng, device), device=device)
    state = {"params": params, "opt": adamw_init(params)}
    if compress:
        state["ef"] = init_ef_buffers(params)
    return state


def init_ef_buffers(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _device_of(tree) -> torch.device:
    return tree_flatten(tree)[0][1].device


def device_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v)))
            .to(device) for k, v in batch.items()}


def loss_and_grads(model, params, batch, group: Optional[ModelGroup] = None
                   ) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(metrics, gradient tree) of ``model.loss_fn`` at ``params``; each
    gradient in its parameter's dtype, as ``jax.grad`` gives it.  With
    ``group``, ``params`` is the group's list of lane trees and the
    gradient a list of trees, one a lane: each lane's pieces' gradient
    (a leaf the lanes hold alike gets the same whole gradient on each)."""
    trees = list(params) if group is not None else [params]
    flats = [tree_flatten(t) for t in trees]
    leaves = [[p.detach().requires_grad_(True) for _, p in flat] for flat in flats]
    with torch.enable_grad():
        lanes = [tree_unflatten((n, t) for (n, _), t in zip(flat, ls))
                 for flat, ls in zip(flats, leaves)]
        if group is not None:
            total, metrics = model.loss_fn(lanes, batch, group=group)
        else:
            total, metrics = model.loss_fn(lanes[0], batch)
        grads = torch.autograd.grad(total, [t for ls in leaves for t in ls], allow_unused=True)
    out, i = [], 0
    for flat, ls in zip(flats, leaves):
        gs = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads[i:], ls)]
        out.append(tree_unflatten((n, g) for (n, _), g in zip(flat, gs)))
        i += len(ls)
    return {k: v.detach() for k, v in metrics.items()}, (out if group is not None else out[0])


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def accumulate_grads(model, lanes, batch, microbatches: int = 1
                     ) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(metrics, gradient) of the batch's mean loss over ``lanes``, a list
    of (parameter tree, device), with ``batch`` on the first lane's
    device.  On a mesh with a model axis each lane is a data lane,
    (its model group's list of lane trees, :class:`~repro_torch.models.
    parallel.ModelGroup`), and the gradient a list of trees, one a model
    lane: lane m's pieces' gradient, summed on the first group's m-th
    device.

    Microbatch ``i`` is cut into one contiguous part a lane; the parts'
    gradients are summed in f32 on the first lane's device, microbatch-
    major and in lane order (each weighted by its lane's share of the
    microbatch's ``loss_mask`` tokens where there are several lanes), and
    divided by the number of parts: the reference's microbatch
    accumulation, so L lanes give the one-lane ``microbatches=L``
    gradient bit for bit where the lanes count the same tokens.  The loss
    is the parts' (weighted) mean, the other metrics the last part's.  One
    lane and one microbatch return the gradient in the parameters' dtype,
    as ``jax.grad`` gives it."""
    where, n_lanes, m = lanes[0][1], len(lanes), microbatches
    grouped = isinstance(where, ModelGroup)
    home = where.home if grouped else where
    if n_lanes == 1 and m == 1:
        return loss_and_grads(model, lanes[0][0], batch, where if grouped else None)
    rows = len(next(iter(batch.values())))
    if rows % (m * n_lanes):
        raise ValueError(f"a batch of {rows} rows does not split into {m} microbatch(es) "
                         f"over {n_lanes} lane(s)")
    n = rows // (m * n_lanes)
    accs = [tree_map(lambda p, d=d: torch.zeros(p.shape, dtype=torch.float32, device=d), tree)
            for tree, d in (zip(lanes[0][0], where.devices) if grouped else [(lanes[0][0], home)])]
    loss_acc = torch.zeros((), dtype=torch.float32, device=home)
    for i in range(m):
        parts = [{k: _on(v[(i * n_lanes + j) * n:(i * n_lanes + j + 1) * n],
                         wh.home if grouped else wh)
                  for k, v in batch.items()} for j, (_, wh) in enumerate(lanes)]
        weights = [None] * n_lanes
        if n_lanes > 1 and "loss_mask" in batch:
            counts = [_on(p["loss_mask"].float().sum(), home) for p in parts]
            total = torch.clamp(sum(counts[1:], counts[0]), min=1.0)
            weights = [c * n_lanes / total for c in counts]
        for (params, wh), part, w in zip(lanes, parts, weights):
            metrics, g = loss_and_grads(model, params, part, wh if grouped else None)
            with torch.no_grad():          # in place: the sums of a + b, one buffer
                for acc, lane_g in zip(accs, g if grouped else [g]):
                    for (_, a), (_, b) in zip(tree_flatten(acc), tree_flatten(lane_g)):
                        b = _on(b, a.device).float()   # across cards in the grad's dtype
                        a.add_(b if w is None else b * _on(w, a.device))
            loss = _on(metrics["loss"], home)
            loss_acc = loss_acc + (loss if w is None else loss * w)
            del g
    with torch.no_grad():
        for acc in accs:
            for _, g in tree_flatten(acc):
                g.div_(m * n_lanes)
    return {**{k: _on(v, home) for k, v in metrics.items()}, "loss": loss_acc / (m * n_lanes)}, \
        (accs if grouped else accs[0])


def _within(sl: Tuple[slice, ...], index) -> Tuple[slice, ...]:
    """The global slices ``sl`` within a piece whose ``[[start, stop],
    ...]`` is ``index``."""
    return tuple(slice(s.start - a, s.stop - a) for s, (a, _) in zip(sl, index))


def compress_grads(grads, ef_tree):
    """The int8 error-feedback quantization of the (reduced) gradient:
    each piece of a leaf's error buffer (the whole buffer on one device, a
    ZeRO-1 piece a grid position on a mesh) quantizes its slice of the
    gradient (of the gradient's piece of its ``model`` coordinate on a
    mesh) with the leaf's one scale (the max over the pieces is exact) and
    keeps its error.  Returns the dequantized gradient in f32, written in
    place where the gradient is f32."""
    ef = dict(tree_flatten(ef_tree))
    out = []
    with torch.no_grad():
        for name, g in tree_flatten(grads):
            e = ef[name]
            placed = isinstance(g, Sharded)
            gp = g.pieces if placed else [g]

            def local(sl, i, g=g, placed=placed):
                return _within(sl, g.index(i)) if placed else sl

            pieces = ([(e.slices(k), p, k % len(gp)) for k, p in enumerate(e.pieces)]
                      if isinstance(e, Sharded) else [((), e, 0)])
            gfs = [_on(gp[i][local(sl, i)], p.device).float() + p for sl, p, i in pieces]
            amax = torch.stack([_on(gf.abs().max(), gp[0].device) for gf in gfs]).max()
            scale = torch.clamp(amax, min=1e-12) / 127.0
            dst = [t if t.dtype == torch.float32 else torch.empty(
                t.shape, dtype=torch.float32, device=t.device) for t in gp]
            for (sl, p, i), gf in zip(pieces, gfs):
                s = _on(scale, p.device)
                deq = torch.clamp(torch.round(gf / s), -127, 127).to(torch.int8).float() * s
                p.copy_(gf - deq)
                dst[i][local(sl, i)].copy_(_on(deq, dst[i].device))
            out.append((name, Sharded(g.placement, g.shape, dst) if placed else dst[0]))
    return tree_unflatten(out)


def _mark(marks, device: torch.device):
    """An event of ``marks`` (a :class:`~repro_torch.core.process._Phases`)
    recorded now on ``device``'s current stream."""
    return marks.mark(torch.cuda.current_stream(device) if device.type == "cuda" else None)


def make_train_step(model, tcfg: TrainConfig):
    """``step(state, batch, marks=None) -> (state, metrics)``: microbatch
    accumulation in the reference's order (:func:`accumulate_grads` over
    one lane), optional compression, then AdamW; the state is updated in
    place.  ``marks`` (a :class:`~repro_torch.core.process._Phases`)
    gets the ``"train.optimizer"`` span's events, recorded where the
    gradient meets the optimizer and after AdamW has cast the new
    parameters: between them run the compression, the clip's global norm,
    AdamW and the cast (:class:`TrainProcess` keeps the span)."""

    def step(state, batch, marks=None):
        params = state["params"]
        device = _device_of(params)
        metrics, grads = accumulate_grads(model, [(params, device)],
                                          device_batch(batch, device), tcfg.microbatches)
        start = _mark(marks, device) if marks is not None else None
        if tcfg.compress_grads:
            # error-feedback int8 quantization of the gradient signal; the
            # EF buffer lives in the state so the bias telescopes
            grads = compress_grads(grads, state["ef"])
        _, _, opt_metrics = adamw_update(params, grads, state["opt"], tcfg.opt)
        if marks is not None:
            marks.spans.append(("train.optimizer", start, _mark(marks, device)))
        return state, {**metrics, **opt_metrics}

    return step


# ---------------------------------------------------------------------------
# Sharding trees
# ---------------------------------------------------------------------------

def state_pspecs(model, state) -> Dict[str, Any]:
    """The spec tree of a train state (the reference's): the parameters
    by the model's partition rules, ``master``/``m``/``v`` (and ``ef``)
    each with ZeRO-1 over ``data`` on top (:func:`~repro_torch.models.
    common.zero1_spec`), ``step`` replicated."""
    param_specs = tree_paths(partition_tree(state["params"], model.partition_rules()))

    def opt_spec(tree):
        return tree_unflatten((n, zero1_spec(param_specs[n], tuple(leaf.shape)))
                              for n, leaf in tree_flatten(tree))

    specs = {"params": tree_unflatten(param_specs.items()),
             "opt": {"master": opt_spec(state["opt"]["master"]),
                     "m": opt_spec(state["opt"]["m"]),
                     "v": opt_spec(state["opt"]["v"]),
                     "step": ()}}
    if "ef" in state:
        specs["ef"] = opt_spec(state["ef"])
    return specs


def batch_pspecs(batch, mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """The batch's spec tree: rows over ``(pod, data)``.  With ``mesh``,
    an axis the mesh lacks replicates (the reference names ``pod`` on a
    (data, model) mesh too, which a JAX mesh refuses)."""
    def spec(a):
        s = (BATCH_AXES,) + (None,) * (len(tuple(a.shape)) - 1)
        return resolve_spec(s, mesh) if mesh is not None else s
    return tree_map(spec, batch)


def to_named(spec_tree, mesh: Mesh) -> Any:
    """A tree of :class:`~repro_torch.launch.mesh.Placement` over ``mesh``
    (axes the mesh lacks replicate)."""
    return tree_map(lambda s: Placement(mesh, resolve_spec(s, mesh)), spec_tree)


def shard_state(state, shardings) -> Dict[str, Any]:
    """``state`` placed by ``shardings`` (a :func:`to_named` tree): each
    tensor leaf cut into its :class:`~repro_torch.launch.mesh.Sharded`
    pieces, one a grid position, each on its device."""
    places = dict(tree_flatten(shardings))
    return tree_unflatten((n, Sharded.place(leaf, places[n]) if isinstance(leaf, torch.Tensor)
                           else leaf) for n, leaf in tree_flatten(state))


def train_state_specs(model, compress: bool = False) -> Dict[str, Any]:
    """The layout of :func:`make_train_state`'s state as
    :class:`~repro_torch.core.data.TensorSpec` leaves (nothing
    allocated): what :func:`state_pspecs` and a restore onto a mesh
    read."""
    params = model.param_specs()
    f32 = tree_map(lambda s: TensorSpec(tuple(s.shape), np.dtype(np.float32)), params)
    state = {"params": params, "opt": {"master": f32, "m": f32, "v": f32,
                                       "step": TensorSpec((), np.dtype(np.int32))}}
    if compress:
        state["ef"] = f32
    return state


def init_mesh_state(model, rng, mesh: Mesh, compress: bool = False) -> Dict[str, Any]:
    """``shard_state(make_train_state(model, rng, compress), ...)`` by
    :func:`state_pspecs`, bit for bit, placed leaf by leaf: the parameters
    are drawn on the mesh's first device as on one device, and each is
    cut into its replicas and its ``master`` pieces and then dropped; the
    moments (and ``ef``) are made as zero pieces.  So no device holds the
    unplaced master and moments, and the first holds at most one
    parameter tree beside the placed state."""
    home = mesh.devices.flat[0]
    places = dict(tree_flatten(to_named(state_pspecs(model, train_state_specs(model, compress)),
                                        mesh)))
    flat = tree_flatten(model.init_params(_generator(rng, home), device=home))
    zeros = ("['opt']['m']", "['opt']['v']") + (("['ef']",) if compress else ())
    out = []
    for i in range(len(flat)):
        name, p = flat[i]
        flat[i] = None
        out.append(("['params']" + name, Sharded.place(p, places["['params']" + name])))
        key = "['opt']['master']" + name
        out.append((key, Sharded.place(p.to(torch.float32), places[key])))
        out += [(z + name, Sharded.zeros(p.shape, torch.float32, places[z + name]))
                for z in zeros]
        del p
    step = torch.zeros((), dtype=torch.int32, device=home)
    out.append(("['opt']['step']", Sharded.place(step, places["['opt']['step']"])))
    return tree_unflatten(out)


def is_mesh_state(state) -> bool:
    return isinstance(tree_flatten(state["params"])[0][1], Sharded)


def check_train_mesh(mesh: Mesh, model) -> None:
    """What cannot run on a training mesh, found before anything is
    placed: a device that is not present, and a parameter dimension that
    its partition rule splits over axes that do not divide it (as a JAX
    ``NamedSharding`` refuses it)."""
    check_present(mesh)
    specs = dict(tree_flatten(state_pspecs(model, train_state_specs(model))["params"]))
    for name, spec in tree_flatten(model.param_specs()):
        try:
            piece_index(spec.shape, specs[name], mesh, 0)
        except ValueError as e:
            raise ValueError(f"{type(model).__name__} {name} on the mesh {mesh.shape}: "
                             f"{e}") from None


def mesh_lanes(params, mesh: Mesh) -> list:
    """The data lanes of a placed parameter tree, as :func:`accumulate_grads`
    takes them: (a grid position's tree, its device) on a data-only mesh;
    (the model group's M trees, its :class:`~repro_torch.models.parallel.
    ModelGroup`) with a model axis."""
    n_model = model_axis_size(mesh)
    if n_model == 1:
        return [(tree_map(lambda s, j=j: s.pieces[j], params), g[0])
                for j, g in enumerate(mesh.groups)]
    return [([tree_map(lambda s, k=d * n_model + m: s.pieces[k], params)
              for m in range(n_model)], ModelGroup(g)) for d, g in enumerate(mesh.groups)]


def gradient_pieces(grads, params, mesh: Mesh) -> Dict[str, Any]:
    """:func:`accumulate_grads`' gradient over :func:`mesh_lanes` of the
    placed ``params`` as :class:`Sharded` leaves over the mesh's first
    model group: each model lane's piece (a leaf the lanes hold alike, a
    copy a lane), as :func:`~repro_torch.optim.adamw.global_norm` and the
    update read them."""
    n_model = model_axis_size(mesh)
    group = Mesh([list(mesh.groups[0])])
    lanes = [dict(tree_flatten(t)) for t in (grads if n_model > 1 else [grads])]
    return tree_unflatten(
        (n, Sharded(Placement(group, p.placement.spec), p.shape, [g[n] for g in lanes]))
        for n, p in tree_flatten(params))


def record_data_traffic(leaves, n_data: int) -> None:
    """Record, with a recorder active (:func:`~repro_torch.models.parallel.
    recording`), what one step moves over the data axes of a mesh of
    ``n_data`` model groups: for each ``(name, bytes of a lane's gradient
    piece, whether its optimizer state is split over data)`` of
    ``leaves``, the lanes' gradient sum as an ``all-reduce``, or, where
    the optimizer state is in ZeRO-1 pieces, a ``reduce-scatter`` of the
    gradient and an ``all-gather`` of the updated parameter piece (the
    gradient crosses in the parameter's dtype, so both move its bytes)."""
    rec = tp.recorder()
    if rec is None or n_data == 1:
        return
    for name, nbytes, split in leaves:
        if split:
            rec.collective("reduce-scatter", nbytes, name, "data")
            rec.collective("all-gather", nbytes, name, "data")
        else:
            rec.collective("all-reduce", nbytes, name, "data")


def splits_over_data(spec) -> bool:
    """Whether a placement spec splits a dim over a data axis."""
    return any(a in BATCH_AXES for e in spec if e is not None
               for a in ((e,) if isinstance(e, str) else e))


def make_mesh_train_step(model, tcfg: TrainConfig, mesh: Mesh):
    """``step(state, batch) -> (state, metrics)`` over the lanes of
    ``mesh`` on a state placed by :func:`shard_state` (in place).

    The gradient is :func:`accumulate_grads` over the data lanes
    (:func:`mesh_lanes`; the gradient of the global batch's mean loss, in
    the pieces of the first model group's lanes; with ``compress_grads``
    quantized as on one device, each grid position holding its ZeRO-1
    piece of the error buffer).  Then the global norm (each distinct piece
    once) and AdamW's scalars of the whole gradient, each grid position's
    update of its pieces, and its new parameter piece copied into every
    replica that shares its ``model`` coordinate.  ``marks`` records the
    ``"train.optimizer"`` events as :func:`make_train_step`'s do, on the
    first device's stream: over distinct cards they time that card's
    share of the update."""
    check_train_mesh(mesh, model)
    n_model = model_axis_size(mesh)
    devs = mesh.device_list
    home, positions = devs[0], range(len(devs))

    def step(state, batch, marks=None):
        params = state["params"]
        metrics, grads = accumulate_grads(model, mesh_lanes(params, mesh),
                                          device_batch(batch, home), tcfg.microbatches)
        grads = gradient_pieces(grads, params, mesh)
        if tp.recorder() is not None:
            masters = dict(tree_flatten(state["opt"]["master"]))
            record_data_traffic([(n, p.pieces[0].numel() * p.pieces[0].element_size(),
                                  splits_over_data(masters[n].placement.spec))
                                 for n, p in tree_flatten(params)], len(mesh.groups))
        start = _mark(marks, home) if marks is not None else None
        with torch.no_grad():
            if tcfg.compress_grads:
                grads = compress_grads(grads, state["ef"])
            opt = state["opt"]
            sc = adamw_scalars(opt["step"].pieces[0], grads, tcfg.opt)
            scs = [{k: _on(v, devs[j]) if isinstance(v, torch.Tensor) else v
                    for k, v in sc.items()} for j in positions]
            masters, ms, vs, gs = (dict(tree_flatten(t)) for t in
                                   (opt["master"], opt["m"], opt["v"], grads))
            for name, ps in tree_flatten(params):
                g = gs[name]
                for j in positions:
                    lane = j % n_model
                    sl = masters[name].slices(j)
                    new = torch.empty(masters[name].pieces[j].shape, dtype=ps.dtype,
                                      device=devs[j])
                    update_leaf(new, masters[name].pieces[j],
                                _on(g.pieces[lane][_within(sl, g.index(lane))], devs[j]),
                                ms[name].pieces[j], vs[name].pieces[j], scs[j], tcfg.opt)
                    for k in positions[lane::n_model]:   # into its model coordinate's replicas
                        ps.pieces[k][_within(sl, ps.index(k))].copy_(new)
            for j in positions:
                opt["step"].pieces[j].copy_(scs[j]["step"])
        if marks is not None:
            marks.spans.append(("train.optimizer", start, _mark(marks, home)))
        return state, {**metrics, "lr": sc["lr"], "grad_norm": sc["grad_norm"]}

    return step


# ---------------------------------------------------------------------------
# Paper-style Process wrapper (init/launch split at the train-step level)
# ---------------------------------------------------------------------------

class TrainProcess:
    """OpenCLIPER Process semantics for the training step.

    On a CUDA device, ``init(state, batch)`` runs the forward and backward
    once, eagerly, on a side stream (autograd, cuBLAS and the allocator
    set themselves up; the state is not changed), then captures the whole
    step (forward, remat recompute, backward, clip, AdamW) into one CUDA
    graph through :func:`repro_torch.core.process.capture_graph`, which
    runs nothing.  ``launch(state, batch)`` copies the batch into the
    captured input tensors and replays the graph: one host call a step,
    no host value read.  It takes the state ``init`` captured (updated in
    place by each replay) and returns it with the metrics, tensors that
    every replay overwrites.  Kernel launches are counted as for a
    captured process launch (the capture's tally, added at each replay).
    On the CPU, ``launch`` runs the step eagerly.

    With ``mesh`` the step runs over the mesh's lanes
    (:func:`make_mesh_train_step`): data parallel over ``data``, and over
    ``model`` tensor parallel by the model's partition rules (each model
    group's lanes run their pieces of every layer).  ``init`` places a
    plain state by :func:`state_pspecs` (:func:`shard_state`;
    :attr:`state` is the placed state, which ``launch`` also takes), warms
    up the first data lane's forward and backward (its whole model group)
    and, when every lane is on one card, captures every lane's work into
    the one graph.  Over distinct cards the step runs eagerly (a CUDA graph
    records one device's work).  A mesh whose axes do not divide a
    parameter dimension that its rule splits raises ``ValueError``
    (:func:`check_train_mesh`).

    While a ``torch.profiler`` runs, ``launch`` keeps the spans
    ``train.launch`` and ``train.replay`` and the device span
    ``train.optimizer`` (:mod:`repro_torch.core.trace`): the captured
    step records its pair of events at every replay, and the pair of a
    replay launched under a profiler is read, without waiting, at the next
    launch or by :func:`~repro_torch.core.trace.spans`.  It is kept only for
    a step that has completed before the next launch records the pair
    again: a loop that launches ahead of the card loses the others, which
    :func:`~repro_torch.core.trace.dropped` counts.
    """

    def __init__(self, model, tcfg: TrainConfig, mesh: Optional[Mesh] = None):
        self.model, self.tcfg, self.mesh = model, tcfg, mesh
        if mesh is not None:
            self.step = make_mesh_train_step(model, tcfg, mesh)
        else:
            self.step = make_train_step(model, tcfg)
        self._state = self._given = None
        self._batch: Dict[str, torch.Tensor] = {}
        self._replay = None
        self._tally: Dict[str, int] = {}
        self._metrics: Dict[str, torch.Tensor] = {}
        self._device: Optional[torch.device] = None
        #: the captured step's ``train.optimizer`` events, recorded by every replay
        self._marks: Optional[_process._Phases] = None
        #: the device spans of the last launch under a profiler, not read yet
        self._pending: list = []
        self.captures = self.replays = 0

    @property
    def state(self):
        """The state ``init`` captured (placed on the mesh with one)."""
        return self._state

    @property
    def metrics(self) -> Dict[str, torch.Tensor]:
        """The last replay's metrics (tensors every replay overwrites)."""
        return self._metrics

    def init(self, state, batch) -> "TrainProcess":
        self._given = state
        if self.mesh is not None:
            if not is_mesh_state(state):
                state = shard_state(state, to_named(state_pspecs(self.model, state), self.mesh))
            device = self.mesh.devices.flat[0]
            lane0, where = mesh_lanes(state["params"], self.mesh)[0]
            group = where if isinstance(where, ModelGroup) else None
            one_device = len(self.mesh.device_set) == 1
        else:
            device = _device_of(state["params"])
            lane0, group, one_device = state["params"], None, True
        self._state, self._device = state, device
        self._batch = {k: v.clone() for k, v in device_batch(batch, device).items()}
        self._replay = self._marks = None
        if not (_process._graphs_on(device) and one_device):
            return self
        rows = len(next(iter(self._batch.values())))
        part = rows // ((len(self.mesh.groups) if self.mesh is not None else 1)
                        * self.tcfg.microbatches)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            loss_and_grads(self.model, lane0, {k: v[:part] for k, v in self._batch.items()},
                           group)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        tally: Dict[str, int] = {}
        marks = _process._Phases(device, external=True)

        def body() -> None:
            marks.spans.clear()                  # a body run again records anew
            with counting_into(tally, device):
                self._metrics = self.step(state, self._batch, marks)[1]

        self._replay = _process.capture_graph(body, device)
        self._tally, self._marks = dict(tally), marks
        self.captures += 1
        return self

    def launch(self, state, batch):
        with trace.span("train.launch"):
            for p in self._pending:              # before the replay records its events again
                trace.settle(p, last=True)
            self._pending = []
            if self._state is None:
                raise RuntimeError("TrainProcess.init() not called")
            if state is not self._state and state is not self._given:
                raise ValueError("launch() takes the state that init() captured")
            state = self._state
            if set(batch) != set(self._batch):
                raise ValueError(f"batch has {sorted(batch)}, init() captured "
                                 f"{sorted(self._batch)}")
            for k, v in batch.items():
                src = (v if isinstance(v, torch.Tensor)
                       else torch.from_numpy(np.ascontiguousarray(v)))
                if tuple(src.shape) != tuple(self._batch[k].shape):
                    raise ValueError(f"{k}: shape {tuple(src.shape)}, init() captured "
                                     f"{tuple(self._batch[k].shape)}")
                self._batch[k].copy_(src)
            traced = trace.active()
            if self._replay is None:
                marks = _process._Phases(self._device) if traced else None
                state, self._metrics = self.step(state, self._batch, marks)
            else:
                with trace.span("train.replay"):
                    self._replay()
                add_launches(self._tally)
                self.replays += 1
                marks = self._marks if traced else None
            if marks is not None and marks.spans:
                ready = _mark(_process._Phases(self._device), self._device)
                self._pending = [p for p in (trace.device_span(name, a, b, ready)
                                             for name, a, b in marks.spans) if p is not None]
            return state, self._metrics
