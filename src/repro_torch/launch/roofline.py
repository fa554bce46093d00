"""Backend check for the ``use_kernel`` switch of the processes.

Each kernel wrapper already runs its plain version for CPU tensors and its
CUDA kernel for CUDA tensors, so ``"auto"`` needs no decision here.
``resolve_backend`` only holds a forced choice against the device.  The
timed ``KernelChooser`` of the reference lands here in a later slice.
"""
from __future__ import annotations

import torch


def resolve_backend(use_kernel: bool | str, *tensors: torch.Tensor) -> bool:
    """Whether the CUDA kernel runs for ``tensors`` (else the plain version).

    ``"auto"`` follows the device.  A forced choice must agree with it: the
    kernel exists only on the card (``True`` with CPU tensors raises), and
    the plain version serves only the CPU (``False`` with CUDA tensors
    raises), so neither the card nor the kernel is ever bypassed silently.
    ``meta`` tensors (shape inference) take the plain version.
    """
    if use_kernel not in (True, False, "auto"):
        raise ValueError(f"use_kernel={use_kernel!r}: expected True, False or 'auto'")
    kinds = {t.device.type for t in tensors}
    if kinds == {"meta"}:
        return False
    if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {sorted(kinds)}")
    on_cuda = kinds == {"cuda"}
    if use_kernel is True and not on_cuda:
        raise ValueError("use_kernel=True: the hand-written kernels run only "
                         "on CUDA tensors; these lie on the CPU")
    if use_kernel is False and on_cuda:
        raise ValueError("use_kernel=False: the plain version serves only CPU "
                         "tensors; these lie on the card")
    return on_cuda
