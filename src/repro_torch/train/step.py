"""Train-step factory: loss, gradient (microbatch accumulation), optional
int8 error-feedback compression, clip and AdamW.  Mirrors
``repro/train/step.py`` on one device.

``make_train_step`` returns the step as a plain function, ``(state,
batch) -> (state, metrics)``, that updates the state's tensors in place
(the reference's is pure and donates its input state).
:class:`TrainProcess` is the paper's init/launch split at training scale:
``init()`` captures the whole step (forward, backward, clip, AdamW) into
one CUDA graph, ``launch()`` copies the batch into the captured input and
replays it.  The mesh specs (``state_pspecs``, ``batch_pspecs``,
``to_named``) wait for the multi-GPU slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import process as _process
from repro_torch.core.arena import tree_flatten, tree_unflatten
from repro_torch.core.registry import add_launches, counting_into
from repro_torch.models.common import tree_map
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compress import ef_int8_compress

_MESH = ("mesh shardings of the train state wait for the multi-GPU slice "
         "(ROADMAP.md queue 1, item 6)")


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


def make_train_state(model, rng, compress: bool = False, *, device="cpu") -> Dict[str, Any]:
    """{"params", "opt": {"master", "m", "v", "step"}[, "ef"]}: the
    reference's layout (and checkpoint leaf names), on ``device``; ``rng``
    an int seed or a ``torch.Generator`` on ``device``."""
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


def loss_and_grads(model, params, batch) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(metrics, gradient tree) of ``model.loss_fn`` at ``params``; each
    gradient in its parameter's dtype, as ``jax.grad`` gives it."""
    flat = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    with torch.enable_grad():
        tree = tree_unflatten((n, t) for (n, _), t in zip(flat, leaves))
        total, metrics = model.loss_fn(tree, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, leaves)]
    return ({k: v.detach() for k, v in metrics.items()},
            tree_unflatten((n, g) for (n, _), g in zip(flat, grads)))


def make_train_step(model, tcfg: TrainConfig):
    """``step(state, batch) -> (state, metrics)``: microbatch accumulation
    in the reference's order (f32 sums from zero, then / m; the loss the
    microbatches' mean, the other metrics the last one's), optional
    compression, then AdamW; the state is updated in place."""

    def step(state, batch):
        params = state["params"]
        batch = device_batch(batch, _device_of(params))
        m = tcfg.microbatches
        if m > 1:
            parts = {k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss_acc = torch.zeros((), dtype=torch.float32, device=_device_of(params))
            for i in range(m):
                metrics, g = loss_and_grads(model, params, {k: v[i] for k, v in parts.items()})
                g_acc = tree_unflatten((n, a + b.float()) for (n, a), (_, b) in
                                       zip(tree_flatten(g_acc), tree_flatten(g)))
                loss_acc = loss_acc + metrics["loss"]
            grads = tree_map(lambda g: g / m, g_acc)
            metrics = {**metrics, "loss": loss_acc / m}
        else:
            metrics, grads = loss_and_grads(model, params, batch)

        if tcfg.compress_grads:
            # error-feedback int8 quantization of the gradient signal; the
            # EF buffer lives in the state so the bias telescopes
            new_g = []
            ef = dict(tree_flatten(state["ef"]))
            with torch.no_grad():
                for name, g in tree_flatten(grads):
                    qi, scale, new_e = ef_int8_compress(g, ef[name])
                    new_g.append((name, qi.float() * scale))
                    ef[name].copy_(new_e)
            grads = tree_unflatten(new_g)
        _, _, opt_metrics = adamw_update(params, grads, state["opt"], tcfg.opt)
        return state, {**metrics, **opt_metrics}

    return step


def state_pspecs(model, state):
    raise NotImplementedError(_MESH)


def batch_pspecs(batch):
    raise NotImplementedError(_MESH)


def to_named(spec_tree, mesh):
    raise NotImplementedError(_MESH)


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
    """

    def __init__(self, model, tcfg: TrainConfig, mesh=None):
        if mesh is not None:
            raise NotImplementedError(_MESH)
        self.model, self.tcfg = model, tcfg
        self.step = make_train_step(model, tcfg)
        self._state = None
        self._batch: Dict[str, torch.Tensor] = {}
        self._replay = None
        self._tally: Dict[str, int] = {}
        self._metrics: Dict[str, torch.Tensor] = {}
        self.captures = self.replays = 0

    def init(self, state, batch) -> "TrainProcess":
        device = _device_of(state["params"])
        self._state = state
        self._batch = {k: v.clone() for k, v in device_batch(batch, device).items()}
        self._replay = None
        if not _process._graphs_on(device):
            return self
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            loss_and_grads(self.model, state["params"], self._batch)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        tally: Dict[str, int] = {}

        def body() -> None:
            with counting_into(tally):
                self._metrics = self.step(state, self._batch)[1]

        self._replay = _process.capture_graph(body, device)
        self._tally = dict(tally)
        self.captures += 1
        return self

    def launch(self, state, batch):
        if self._state is None:
            raise RuntimeError("TrainProcess.init() not called")
        if state is not self._state:
            raise ValueError("launch() takes the state that init() captured")
        if set(batch) != set(self._batch):
            raise ValueError(f"batch has {sorted(batch)}, init() captured {sorted(self._batch)}")
        for k, v in batch.items():
            src = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
            if tuple(src.shape) != tuple(self._batch[k].shape):
                raise ValueError(f"{k}: shape {tuple(src.shape)}, init() captured "
                                 f"{tuple(self._batch[k].shape)}")
            self._batch[k].copy_(src)
        if self._replay is None:
            return self.step(state, self._batch)
        self._replay()
        add_launches(self._tally)
        self.replays += 1
        return state, self._metrics
