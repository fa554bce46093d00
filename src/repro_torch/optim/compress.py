"""Error-feedback int8 gradient compression, mirroring
``repro/optim/compress.py``: each tensor is quantized to int8 with one
scale, and the quantization error is kept in an f32 buffer and added back
at the next step, so the compression bias telescopes away (Karimireddy et
al., 2019).  The train step applies it to the gradient with
``compress_grads`` (quantize then dequantize, on a mesh to the reduced
gradient, each lane its ZeRO-1 piece of the error buffer).
:func:`dp_mean_compressed` is the reference's int8 all-reduce mean over
the data lanes; as in the reference, the train step does not call it."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

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


def dp_mean_compressed(gs: Sequence[torch.Tensor], errs: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The int8 all-reduce mean over the data lanes: ``gs`` holds each
    lane's tensor and ``errs`` its error buffer, in lane order.  Each lane
    quantizes its own tensor; the int8 payloads are summed in int32 and the
    scales in f32, in lane order, on the first lane's device, and the mean
    is ``qsum * (ssum / n) / n`` (every lane dequantized with the mean
    scale, the reference's reconstruction).  Returns the mean, on the
    first lane's device, and each lane's new error buffer."""
    if len(gs) != len(errs) or not gs:
        raise ValueError(f"{len(gs)} tensors and {len(errs)} error buffers: one of each a lane")
    home = gs[0].device
    qsum = ssum = None
    new_errs = []
    for g, err in zip(gs, errs):
        q, scale, new_err = ef_int8_compress(g, err)
        q32, scale = q.to(torch.int32).to(home), scale.to(home)
        qsum = q32 if qsum is None else qsum + q32
        ssum = scale if ssum is None else ssum + scale
        new_errs.append(new_err)
    n = len(gs)
    return qsum.to(torch.float32) * (ssum / n) / n, new_errs
