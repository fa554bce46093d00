"""Learning-rate schedules, mirroring ``repro/optim/schedule.py``.

A schedule is called with the optimizer's step as a 0-d tensor on the
device and returns the rate as a 0-d f32 tensor there, so a step captured
into a CUDA graph reads no host value: every replay computes the rate of
the step counter it finds."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Schedule:
    kind: str = "cosine"          # cosine | linear | constant
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr: float = 3e-5

    def __call__(self, step) -> torch.Tensor:
        s = torch.as_tensor(step).to(torch.float32)
        warm = self.base_lr * torch.clamp(s / max(1, self.warmup_steps), max=1.0)
        frac = torch.clamp((s - self.warmup_steps) / max(1, self.total_steps - self.warmup_steps),
                           0.0, 1.0)
        if self.kind == "cosine":
            decayed = self.min_lr + 0.5 * (self.base_lr - self.min_lr) * (
                1.0 + torch.cos(math.pi * frac))
        elif self.kind == "linear":
            decayed = self.base_lr + (self.min_lr - self.base_lr) * frac
        else:
            decayed = torch.full_like(s, self.base_lr)
        return torch.where(s < self.warmup_steps, warm, decayed)


def make_schedule(kind: str = "cosine", **kw) -> Schedule:
    return Schedule(kind=kind, **kw)
