"""FFT process (paper §IV-A step 0; clFFT there, ``torch.fft`` (cuFFT) here).

The IFFT is a library call in the reference too (``jnp.fft``), not a
hand-written kernel; the one-time plan work happens inside cuFFT's plan
cache on the first launch of a shape.  A stack of frames splits its
``frame`` axis over the mesh's model axis
(:func:`repro_torch.launch.mesh.shard_by_logical`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.process import Port, Process
from repro_torch.launch.mesh import shard_by_logical


@dataclasses.dataclass(frozen=True)
class FFTParams:
    direction: str = "backward"     # "forward" | "backward" (paper: BACKWARD)
    norm: str = "ortho"
    var: str | None = None          # transform only this NDArray (None = all)


BACKWARD = FFTParams("backward")


class FFT(Process):
    """2-D (I)FFT over the trailing two axes of every complex NDArray;
    everything else passes through.  Leading axes (a stream's batch) are
    transformed alike; an item of 3 or more dims has its first (frames)
    split over the model axis."""

    batch_axis = True

    ports = {"in": Port(doc="any Data; complex arrays of ndim>=2 are "
                            "transformed, everything else passes through"),
             "out": Port()}

    def apply(self, views, aux, params, out=None):
        params = params or BACKWARD
        fft2 = torch.fft.ifft2 if params.direction == "backward" else torch.fft.fft2
        lead = 1 if self._batched else 0     # a stream's twin: the batch axis first
        res = {}
        for name, v in views.items():
            if (params.var is None or name == params.var) \
                    and v.is_complex() and v.ndim >= 2:
                def tx(x, _dt=v.dtype):
                    return fft2(x, norm=params.norm).to(_dt)
                if v.ndim - lead >= 3:
                    axes = (None,) * lead + ("frame",) + (None,) * (v.ndim - lead - 1)
                    res[name] = shard_by_logical(tx, [axes], axes)(v)
                else:
                    res[name] = tx(v)
            else:
                res[name] = v
        return res
