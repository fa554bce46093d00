"""Negate process, the paper's listings 2-4 example: ``output[i] = 1.0 -
input[i]`` on every array of a Data set, through the ``negate_kernel``."""
from __future__ import annotations

import numpy as np

from repro_torch.core.process import Port, Process, out_view


class Negate(Process):
    """``output[i] = 1.0 - input[i]`` on every NDArray of the Data set; the
    kernel writes each result straight into the output arena.  It takes no
    launch parameters: the wrapper launches the kernel on CUDA tensors and
    runs the plain version on CPU tensors."""

    kernel_names = ("negate",)
    batch_axis = True

    ports = {"in": Port(dtype=np.floating, doc="any float Data; every NDArray is negated"),
             "out": Port()}

    def out_specs(self, in_specs, aux_specs=None):
        return dict(in_specs)

    def apply(self, views, aux, params, out=None):
        fn = self.getApp().kernels.get("negate_kernel")
        return {name: fn(v, out=out_view(out, name, v.dtype, v.shape))
                for name, v in views.items()}
