"""Training loop with fault tolerance, mirroring ``repro/train/trainer.py``
on one device: periodic asynchronous arena checkpoints, restart from the
newest complete one, deterministic data replay, and a straggler timeout.

* **Checkpoint/restart**: ``CheckpointManager`` writes one contiguous
  blob per interval; on (re)start the trainer restores the newest
  complete step and replays the data stream from exactly that step (the
  stream is a pure function of (seed, shard, step)).  ``simulate_failure_at``
  stops the loop mid-run in tests to prove the invariant: the final
  parameters equal an uninterrupted run's, bit for bit.  The step's
  kernels sum in a fixed order (no float atomics), so this holds on the
  card as on the CPU.
* **Straggler policy**: ``step_timeout_s`` is a wall-clock watchdog; the
  step is waited for outside the captured graph, and a step that took
  longer raises :class:`StepTimeout`, which ``fit_with_restarts`` turns
  into a resume from the last checkpoint.

On a CUDA device ``fit`` runs each step through :class:`~repro_torch.train.
step.TrainProcess` (one capture, then replays); on the CPU it runs the
step eagerly.  With ``mesh`` (a ``(data, model)`` mesh, one process
driving every lane) the state is placed on it leaf by leaf
(:func:`~repro_torch.train.step.init_mesh_state`: each parameter in its
``model`` pieces, a replica a data lane, the optimizer in ZeRO-1 pieces
over ``data`` as well) and every step runs through
``TrainProcess(mesh=)``; a resume restores straight onto the trainer's
mesh, which may have another ``(data, model)`` shape than the run that
wrote the checkpoint (an elastic restart).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.ckpt import CheckpointManager
from .step import (TrainConfig, TrainProcess, check_train_mesh, default_device, init_mesh_state,
                   make_train_state, make_train_step, state_pspecs, to_named, train_state_specs)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_interval: int = 50
    keep_last: int = 3
    log_every: int = 10
    step_timeout_s: Optional[float] = None
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


class StepTimeout(RuntimeError):
    pass


class Trainer:
    def __init__(self, model, cfg: TrainerConfig, mesh=None,
                 log_fn: Callable[[str], None] = print, device=None):
        if mesh is not None:
            check_train_mesh(mesh, model)
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.devices.flat[0] if mesh is not None else default_device(device)
        self.log = log_fn
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, cfg.ckpt_interval, cfg.keep_last)
                     if cfg.ckpt_dir else None)
        self.history: list = []
        #: the TrainProcess of the last ``fit`` on a card (captures, replays)
        self.process: Optional[TrainProcess] = None

    # -- state ---------------------------------------------------------------
    def init_state(self, rng) -> Dict[str, Any]:
        """A fresh state from ``rng``, placed on the trainer's mesh when it
        has one (the same parameters as on one device, placed leaf by
        leaf: :func:`~repro_torch.train.step.init_mesh_state`)."""
        compress = self.cfg.train.compress_grads
        if self.mesh is not None:
            return init_mesh_state(self.model, rng, self.mesh, compress)
        return make_train_state(self.model, rng, compress=compress, device=self.device)

    def resume_or_init(self, rng) -> tuple:
        """Returns (state, start_step).  Restores the newest checkpoint when
        one exists (the restart path after a failure), onto the trainer's
        mesh when it has one: there straight from the state's layout, with
        no fresh state made first."""
        if self.ckpt and self.ckpt.latest() is not None:
            step = self.ckpt.latest()
            if self.mesh is not None:
                like = train_state_specs(self.model, self.cfg.train.compress_grads)
                state = self.ckpt.restore(like, to_named(state_pspecs(self.model, like),
                                                         self.mesh))
            else:
                state = self.ckpt.restore(self.init_state(rng))
            self.log(f"[trainer] resumed from checkpoint step {step}")
            return state, int(step)
        return self.init_state(rng), 0

    # -- loop ----------------------------------------------------------------
    def fit(self, stream, rng, simulate_failure_at: Optional[int] = None):
        """Run to total_steps.  ``stream.batch_at(step)`` supplies data; the
        loop is restartable at any step boundary.  ``rng``: an int seed or
        a ``torch.Generator`` on the trainer's device."""
        state, start = self.resume_or_init(rng)
        if self.device.type == "cuda" or self.mesh is not None:
            self.process = TrainProcess(self.model, self.cfg.train, self.mesh)
            self.process.init(state, stream.batch_at(start))
            run = self.process.launch
        else:
            run = make_train_step(self.model, self.cfg.train)

        for step in range(start, self.cfg.total_steps):
            if simulate_failure_at is not None and step == simulate_failure_at:
                if self.ckpt:
                    self.ckpt.wait()
                raise RuntimeError(f"simulated node failure at step {step}")
            batch = stream.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = run(state, batch)
            if self.cfg.step_timeout_s is not None:
                for d in (self.mesh.device_set if self.mesh is not None else {self.device}):
                    if d.type == "cuda":
                        torch.cuda.synchronize(d)
                dt = time.perf_counter() - t0
                if dt > self.cfg.step_timeout_s:
                    raise StepTimeout(
                        f"step {step} took {dt:.1f}s > {self.cfg.step_timeout_s}s "
                        "(straggler policy: abort + restart from checkpoint)")
            if step % self.cfg.log_every == 0 or step == self.cfg.total_steps - 1:
                loss = float(metrics["loss"])
                self.history.append((step, loss))
                self.log(f"[trainer] step {step} loss {loss:.4f}")
            if self.ckpt:
                self.ckpt.maybe_save(step + 1, state)
        if self.ckpt:
            self.ckpt.maybe_save(self.cfg.total_steps, state, force=True)
            self.ckpt.wait()
        return state

    def fit_with_restarts(self, stream, rng, max_restarts: int = 3, failure_schedule=()):
        """Production wrapper: catch failures, resume from checkpoint."""
        failures = list(failure_schedule)
        for attempt in range(max_restarts + 1):
            try:
                fail_at = failures.pop(0) if failures else None
                return self.fit(stream, rng, simulate_failure_at=fail_at)
            except RuntimeError as e:
                if attempt == max_restarts:
                    raise
                self.log(f"[trainer] failure ({e}); restarting "
                         f"(attempt {attempt + 1}/{max_restarts})")
        raise AssertionError("unreachable")
