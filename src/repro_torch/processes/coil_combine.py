"""Coil-combination processes: XImageSum (paper §IV-A step 2) and RSS
(§IV-B, the Table I/II operation)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.data import TensorSpec
from repro_torch.core.process import Port, Process, out_view
from repro_torch.launch.roofline import resolve_backend


@dataclasses.dataclass(frozen=True)
class CombineParams:
    #: True / False force a backend; "auto" = the kernel on CUDA tensors
    use_kernel: bool | str = "auto"


def _image_shape(shape) -> tuple:
    return tuple(shape[:-3]) + tuple(shape[-2:])


class XImageSum(Process):
    """(F, C, H, W) -> (F, H, W): sum the per-coil x-images (leading batch
    axes folded into F)."""

    batch_axis = True
    kernel_names = ("coil_combine",)

    ports = {"in": Port(names=("kdata",), ndim=4,
                        doc="(frames, coils, H, W) per-coil x-images"),
             "out": Port(names=("xdata",))}

    def out_specs(self, in_specs, aux_specs=None):
        k = in_specs["kdata"]
        return {"xdata": TensorSpec(_image_shape(k.shape), k.dtype)}

    def apply(self, views, aux, params, out=None):
        params = params or CombineParams()
        x = views["kdata"]
        resolve_backend(params.use_kernel, "xImageSum", x)
        return {"xdata": self.getApp().kernels.get("xImageSum")(
            x, out=out_view(out, "xdata", x.dtype, _image_shape(x.shape)))}


class RSSCombine(Process):
    """(F, C, H, W) -> (F, H, W) f32: root-sum-of-squares combination
    (leading batch axes folded into F)."""

    batch_axis = True
    kernel_names = ("coil_combine",)

    ports = {"in": Port(names=("kdata",), ndim=4,
                        doc="(frames, coils, H, W) per-coil images"),
             "out": Port(names=("xdata",))}

    def out_specs(self, in_specs, aux_specs=None):
        k = in_specs["kdata"]
        return {"xdata": TensorSpec(_image_shape(k.shape), np.dtype(np.float32))}

    def apply(self, views, aux, params, out=None):
        params = params or CombineParams()
        x = views["kdata"]
        resolve_backend(params.use_kernel, "rss", x)
        return {"xdata": self.getApp().kernels.get("rss")(
            x, out=out_view(out, "xdata", torch.float32, _image_shape(x.shape)))}
