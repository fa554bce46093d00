"""ComplexElementProd process (paper §IV-A step 1): multiply x-images by
(optionally conjugated) sensitivity maps, in place on the arena."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.process import Port, Process, out_view
from repro_torch.launch.roofline import resolve_backend


@dataclasses.dataclass(frozen=True)
class ComplexElementProdParams:
    conjugate: bool = True
    #: True / False force a backend; "auto" = the kernel on CUDA tensors
    use_kernel: bool | str = "auto"


conjugate = ComplexElementProdParams(conjugate=True)


class ComplexElementProd(Process):
    """kdata[f, c] *= conj?(smaps[c]) — a two-input operator.

    The sensitivity maps come through the ``smaps`` input port when it is
    wired (a separate Data), else from the primary arena
    (``views["sensitivity_maps"]``, the single-KData layout).  With the
    output Data equal to the input the kernel writes the arena in place.
    On a stream's batch, kdata is (B, F, C, H, W) and the maps either one
    set (C, H, W), bound statically, or one set a slice (B, C, H, W).
    """

    batch_axis = True

    kernel_names = ("complex_elementprod",)

    ports = {"in": Port(names=("kdata",), dtype=np.complexfloating,
                        doc="K-/X-space set; needs 'sensitivity_maps' too "
                            "unless the 'smaps' input port is wired"),
             "out": Port(names=("kdata",)),
             "smaps": Port(optional=True, dtype=np.complexfloating,
                           doc="sensitivity maps as a separate Data")}

    def out_specs(self, in_specs, aux_specs=None):
        return dict(in_specs)   # kdata is overwritten in place, same spec

    def apply(self, views, aux, params, out=None):
        params = params or conjugate
        if "smaps" in aux:
            smaps = next(iter(aux["smaps"].values()))
        else:
            smaps = views["sensitivity_maps"]
        k = views["kdata"]
        resolve_backend(params.use_kernel, "complexElementProd", k, smaps)
        prod = self.getApp().kernels.get("complexElementProd")(
            k, smaps, params.conjugate, out=out_view(out, "kdata", k.dtype, k.shape))
        res = dict(views)
        res["kdata"] = prod
        return res
