"""Shared helpers for the kernel wrappers.

The CUDA kernels read complex64 directly as ``float2`` (interleaved re/im,
the layout torch and numpy already use), so there is no re/im plane split
here: that existed only because TPU Pallas has no complex dtype.

:func:`traced` is every registered wrapper's route off the plain launch:
``meta`` inputs (a dry run's trace) and calls under a counting mode
(:class:`repro_torch.launch.roofline.CostMode`).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.core import registry


def counting() -> bool:
    """Whether a counting mode counts this thread's kernel calls (one list
    read when none is active): a wrapper then takes :func:`traced`."""
    return bool(registry.COST_MODES) and registry.counting_mode() is not None


def _on_meta(args, kwargs) -> bool:
    """Whether the first tensor among the arguments (or in a list or tuple
    of them) is on ``meta``."""
    for a in list(args) + list(kwargs.values()):
        for t in (a if isinstance(a, (list, tuple)) else [a]):
            if isinstance(t, torch.Tensor):
                return t.is_meta
    return False


def traced(name: str, run: Callable[[], Any], empty: Callable[[], Any], *args, **kwargs) -> Any:
    """Registered entry ``name``'s call on ``args`` / ``kwargs`` (its own
    arguments, which its cost model reads) off the plain launch.

    On ``meta`` inputs ``empty()`` gives the outputs (the shapes and dtypes
    the plain version returns, and what the kernel allocates beside them),
    and no launch is counted; otherwise ``run()`` is the wrapper's own path
    (the plain version on the CPU, the kernel on the card).  Under a
    counting mode the call counts the entry's ``Cost`` (its flops and
    bytes) and hides the operations of ``empty()`` or ``run()`` from the
    count, so a trace on ``meta`` and a run on the CPU or the card count
    the same work; their allocations still count towards the peak."""
    meta = _on_meta(args, kwargs)
    mode = registry.counting_mode()
    if mode is None:
        return empty() if meta else run()
    entry = registry.KernelRegistry().entry(name)
    with mode.kernel(name, entry.cost, args, kwargs):
        return empty() if meta else run()


def round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def nbytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s elements (a kernel's cost model reads it)."""
    return t.numel() * t.element_size()


def mag2(x: torch.Tensor) -> torch.Tensor:
    """|x|² as a real tensor (x·x for real input)."""
    if x.is_complex():
        return x.real * x.real + x.imag * x.imag
    return x * x


def check_complex64(name: str, t: torch.Tensor, shape: Sequence[int] | None = None,
                    device: torch.device | None = None) -> None:
    """Raise unless ``t`` is a contiguous complex64 CUDA tensor (of
    ``shape``, on ``device``) — what every kernel entry point takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.complex64:
        raise TypeError(f"{name}: kernel takes complex64, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def check_cuda(name: str, t: torch.Tensor, dtypes: Sequence[torch.dtype],
               device: torch.device | None = None, aligned: bool = True) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``
    (on ``device``), 16-byte-aligned unless ``aligned`` is False (for a
    kernel with a path of its own for misaligned pointers).  A transposed
    view handed to a pointer kernel would be read as if it were contiguous,
    so it is refused here."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: kernel takes {list(dtypes)}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor (call .contiguous())")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: kernel takes a 16-byte-aligned tensor")


def check_out(out: torch.Tensor, shape: Sequence[int], dtype: torch.dtype,
              device: torch.device) -> None:
    """Raise unless ``out`` can take a kernel's result in place."""
    if (tuple(out.shape) != tuple(shape) or out.dtype != dtype
            or out.device != device or not out.is_contiguous()):
        raise ValueError(
            f"out: {tuple(out.shape)} {out.dtype} on {out.device}, expected a "
            f"contiguous {tuple(shape)} {dtype} on {device}")


def check_in_place(out: torch.Tensor, src: torch.Tensor) -> None:
    """Raise if ``out`` overlaps ``src`` without being exactly ``src``: an
    elementwise kernel may write over its input only element for element."""
    if out.data_ptr() == src.data_ptr():
        return
    o0, s0 = out.data_ptr(), src.data_ptr()
    o1 = o0 + out.numel() * out.element_size()
    s1 = s0 + src.numel() * src.element_size()
    if o0 < s1 and s0 < o1:
        raise ValueError("out partially overlaps the input")


def out_or_empty(out, shape: Sequence[int], dtype: torch.dtype, device) -> torch.Tensor:
    """``out`` when given, else an uninitialised tensor of the result's
    layout: a wrapper's meta outputs."""
    return out if out is not None else torch.empty(tuple(shape), dtype=dtype, device=device)


def launch_stream(t: torch.Tensor) -> int:
    """Raw handle (an int) of PyTorch's current stream on ``t``'s CUDA
    device, read without building a ``torch.cuda.Stream``."""
    idx = t.get_device()
    if idx < 0:
        raise ValueError(f"expected a CUDA tensor, got {t.device}")
    return torch._C._cuda_getCurrentRawStream(idx)


def launch(entry, t: torch.Tensor, *args) -> int:
    """``entry(*args, stream)``: a kernel entry point called on ``t``'s CUDA
    device with PyTorch's current stream there.  A launch goes to the
    calling thread's current device, so that device is switched to ``t``'s
    for the call, but only when it is not already the current one (the
    common case costs one query, not a switch and a switch back).  Returns
    the entry point's error code."""
    stream = launch_stream(t)
    idx = t.get_device()
    if torch._C._cuda_getDevice() == idx:
        return entry(*args, stream)
    with torch.cuda.device(idx):
        return entry(*args, stream)


def coil_grid(x: torch.Tensor) -> tuple[int, int, int, int]:
    """(frames, coils, H, W) of a (..., C, H, W) stack, leading axes folded."""
    if x.ndim < 3:
        raise ValueError("need (..., C, H, W)")
    c, h, w = x.shape[-3:]
    f = 1
    for s in x.shape[:-3]:
        f *= int(s)
    return f, int(c), int(h), int(w)
