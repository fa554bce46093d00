"""What the drivers share: synchronising, the memory peak, freeing the
program's state before the reference runs, and the checks."""
from __future__ import annotations

import gc

import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device) -> None:
    """Returns the memory of state the caller has dropped, so that the
    reference finds the card empty."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def app_for(device):
    """A ``CLapp`` on ``device`` (the card, or the CPU for the tests)."""
    from repro_torch.core import CLapp, DeviceTraits, DeviceType
    traits = (DeviceTraits(type=DeviceType.CPU) if device.type == "cpu"
              else DeviceTraits(index=device.index or 0))
    return CLapp().init(device_traits=traits)


def check(name: str, value: float, limit: float) -> tuple:
    """(name, value, limit, passed): a number passes at or under its limit."""
    return (name, float(value), float(limit), bool(value <= limit))
