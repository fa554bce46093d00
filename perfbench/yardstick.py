"""The benchmark's frozen arithmetic: the card's data-sheet peaks, the
operations and bytes each measured piece of work needs, and the reduction
of a profiler trace to busy intervals.

Later changes to the program may not move the yardstick, so nothing here
reads the program: each count is worked out from shapes alone.  The
sources they were copied from are named beside each one.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

#: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit (copied from
#: ``repro_torch.launch.roofline.CARD_PEAKS["H100"]``)
H100 = {"hbm_bytes_s": 3.35e12, "fp32": 67e12, "bf16_tensor": 989e12}

COMPLEX64 = 8


# -- the MRI reconstruction (SimpleMRIRecon, staged) --------------------------

def mri_kspace_bytes(frames: int, coils: int, h: int, w: int) -> int:
    return frames * coils * h * w * COMPLEX64


def mri_maps_bytes(coils: int, h: int, w: int) -> int:
    return coils * h * w * COMPLEX64


def mri_image_bytes(frames: int, h: int, w: int) -> int:
    return frames * h * w * COMPLEX64


def mri_launch_bytes(frames: int, coils: int, h: int, w: int) -> int:
    """What one reconstruction needs to move: the k-space and the maps read
    once, the image written once (``mri_fused.fused_recon_cost``)."""
    return (mri_kspace_bytes(frames, coils, h, w) + mri_maps_bytes(coils, h, w)
            + mri_image_bytes(frames, h, w))


def mri_fft_flops(frames: int, coils: int, h: int, w: int) -> float:
    """5 N log2 N a (frame, coil) image of N = H W points, plus the
    product and the coil sum at 8 an element (``fused_recon_cost``)."""
    n = frames * coils * h * w
    return 5.0 * n * math.log2(h * w) + 8.0 * n


def mri_launch_bound_s(frames: int, coils: int, h: int, w: int, peaks=H100) -> float:
    """The least time a launch could take: the larger of its bytes over the
    memory rate and its operations over the fp32 rate."""
    return max(mri_launch_bytes(frames, coils, h, w) / peaks["hbm_bytes_s"],
               mri_fft_flops(frames, coils, h, w) / peaks["fp32"])


# -- the decoder LM -------------------------------------------------------------

def decoder_params(arch: dict) -> int:
    """Parameters of a dense decoder (untied embedding and unembedding,
    SwiGLU MLP, RMSNorm scales, no biases)."""
    d, h, kv, dh, f, v, n = (arch[k] for k in ("d_model", "n_heads", "n_kv_heads", "d_head",
                                               "d_ff", "vocab", "n_layers"))
    layer = d * h * dh + 2 * d * kv * dh + h * dh * d + 3 * d * f + 2 * d
    return n * layer + 2 * v * d + d


def train_step_flops(n_params: int, tokens: int) -> float:
    """6 N tokens (``chip_smoke.model_flops`` for the dense family)."""
    return 6.0 * n_params * tokens


def causal_pairs(sq: int, sk: int, window: int | None = None) -> int:
    """Visible (query, key) pairs of causal attention, queries aligned to the
    end of the keys, within ``window`` keys of each query when given."""
    total = 0
    off = sk - sq
    for i in range(sq):
        hi = i + off
        lo = 0 if window is None else max(0, hi - window + 1)
        total += max(0, hi - lo + 1)
    return total


def flash_bwd_flops(batch: int, q_heads: int, seq: int, d_head: int,
                    window: int | None = None) -> float:
    """10 D flops a visible pair and query head: s and dp recomputed, dv, dk
    and dq (``flash_attention_bwd_cost``)."""
    return 10.0 * batch * q_heads * d_head * causal_pairs(seq, seq, window)


# -- profiler traces --------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace_events: Iterable[dict]) -> List[Tuple[str, str, float, float]]:
    """(category, name, start us, end us) of each device activity (kernel,
    memcpy, memset) of a chrome trace's events (``chip_smoke.py``'s
    ``device_trace``)."""
    return [(e["cat"], e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in trace_events
            if e.get("cat") in DEVICE_CATS and float(e.get("dur", 0) or 0) > 0]


def merged(intervals: Iterable[Sequence[float]]) -> List[List[float]]:
    """Sorted, merged (start, end) intervals (``chip_smoke.py``'s ``merged``)."""
    out: List[List[float]] = []
    for a, b in sorted((float(a), float(b)) for a, b in intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clipped(intervals: Iterable[Sequence[float]], lo: float, hi: float) -> List[List[float]]:
    """The parts of ``intervals`` inside [lo, hi]."""
    return [[max(a, lo), min(b, hi)] for a, b in intervals if min(b, hi) > max(a, lo)]


def busy_us(intervals: Iterable[Sequence[float]]) -> float:
    return sum(b - a for a, b in merged(intervals))


def gaps(intervals: Iterable[Sequence[float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle (start, end) stretches of [lo, hi] between merged intervals."""
    out, t = [], lo
    for a, b in merged(clipped(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out
