"""Error-feedback int8 gradient compression, mirroring
``repro/optim/compress.py``: each tensor is quantized to int8 with one
scale, and the quantization error is kept in an f32 buffer and added back
at the next step, so the compression bias telescopes away (Karimireddy et
al., 2019).  The train step applies it to the gradient with
``compress_grads``; on one device that is quantize then dequantize."""
from __future__ import annotations

from typing import Tuple

import torch

_COLLECTIVE = ("dp_mean_compressed is an all-reduce over the data-parallel devices: it "
               "waits for the multi-GPU slice (ROADMAP.md queue 1, item 6)")


def ef_int8_compress(g: torch.Tensor, err: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad, error buffer) -> (int8 codes, scale (0-d f32), new error)."""
    gf = g.float() + err
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gf - deq


def ef_int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def dp_mean_compressed(g: torch.Tensor, err: torch.Tensor, axis_names):
    """The int8 all-reduce mean over the data-parallel devices."""
    raise NotImplementedError(_COLLECTIVE)
