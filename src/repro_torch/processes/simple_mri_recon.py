"""SimpleMRIRecon (paper listing 6): M = sum_i conj(S_i) . IFFT(Y_i).

A ProcessChain of FFT(BACKWARD) -> ComplexElementProd(conjugate, in place)
-> XImageSum, mirroring the paper's subprocess structure; stage outputs
ARE stage inputs, so no bytes move between stages.  ``mode="fused_kernel"``
is the whole reconstruction as one process (:class:`FusedMRIRecon`).

Frames are independent, so the IFFT and the fused reconstruction split
their ``frame`` axis over the mesh's model axis
(:func:`repro_torch.launch.mesh.shard_by_logical`, a no-op on a 1D mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.app import INVALID_HANDLE, DataHandle
from repro_torch.core.data import TensorSpec
from repro_torch.core.process import Port, Process, ProcessChain, ProfileParameters, out_view
from repro_torch.kernels.common import coil_grid
from repro_torch.kernels.mri_fused import dft_fits, idft_tables
from repro_torch.launch.mesh import shard_by_logical
from repro_torch.launch.roofline import resolve_backend
from .coil_combine import CombineParams, XImageSum
from .complex_elementprod import ComplexElementProd, ComplexElementProdParams
from .fft import FFT, FFTParams


@dataclasses.dataclass(frozen=True)
class FusedReconParams:
    combine: str = "sum"           # "sum" (eq. 1) or "rss" (§IV-B)
    norm: str = "ortho"
    #: True / False force a backend; "auto" = the kernel on CUDA tensors
    use_kernel: bool | str = "auto"


class FusedMRIRecon(Process):
    """The whole SimpleMRIRecon chain as ONE process:
    IFFT2 -> x conj(smaps) -> coil combine, no intermediate arena writes.

    With the kernel backend this is a single CUDA kernel inside the
    :func:`~repro_torch.kernels.mri_fused.dft_fits` gate (its IDFT twiddle
    tables are built once, in ``init()``, on each device of the mesh's
    model group), and cuFFT + the fused epilogue kernel outside it.  The
    maps come from the ``smaps`` port when it is wired, else from the
    primary arena.  On a mesh with a model axis the frames are split over
    the group (each piece on its device, with that device's tables).
    """

    kernel_names = ("mri_fused",)
    batch_axis = True

    ports = {"in": Port(names=("kdata",), dtype=np.complexfloating,
                        doc="multicoil k-space (F, C, H, W); needs "
                            "'sensitivity_maps' too unless 'smaps' is wired"),
             "out": Port(names=("xdata",)),
             "smaps": Port(optional=True, dtype=np.complexfloating,
                           doc="sensitivity maps as a separate Data")}

    def __init__(self, app=None):
        super().__init__(app)
        #: the IDFT tables by device (each device of the model group)
        self._tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def init(self) -> None:
        super().init()
        params = self.launch_params or FusedReconParams()
        app = self.getApp()
        # a stream's batch (B, F, C, H, W) is B * F frames to the kernel
        f, c, h, w = coil_grid(torch.empty(
            app.getData(self.in_handle).specs()["kdata"].shape, device="meta"))
        self._tables = {}
        if app.device.type == "cuda" and dft_fits(f, c, h, w):
            group = app.mesh.groups[0] if app.mesh is not None else (app.device,)
            for dev in dict.fromkeys(group):
                self._tables[dev] = idft_tables(h, w, params.norm, dev)

    def out_specs(self, in_specs, aux_specs=None):
        params = self.launch_params or FusedReconParams()
        k = in_specs["kdata"]
        dtype = np.dtype(np.float32) if params.combine == "rss" else k.dtype
        return {"xdata": TensorSpec(tuple(k.shape[:-3]) + tuple(k.shape[-2:]), dtype)}

    def apply(self, views, aux, params, out=None):
        params = params or FusedReconParams()
        if "smaps" in aux:
            smaps = next(iter(aux["smaps"].values()))
        else:
            smaps = views["sensitivity_maps"]
        k = views["kdata"]
        resolve_backend(params.use_kernel, "mriFusedRecon", k, smaps)
        dtype = torch.float32 if params.combine == "rss" else k.dtype
        kfn = self.getApp().kernels.get("mriFusedRecon")

        def body(kf, sm, out=None):
            return kfn(kf, sm, combine=params.combine, norm=params.norm,
                       tables=self._tables.get(kf.device), out=out)

        # a stream's twin reads (B, F, C, H, W) k-space (and batched maps
        # unless they are static): the item's dims are the trailing ones
        lead_k, lead_s = (None,) * (k.ndim - 4), (None,) * (smaps.ndim - 3)
        return {"xdata": shard_by_logical(
            body, [lead_k + ("frame", "coil", "height", "width"),
                   lead_s + ("coil", "height", "width")],
            lead_k + ("frame", "height", "width"))(
                k, smaps, out=out_view(out, "xdata", dtype, k.shape[:-3] + k.shape[-2:]))}


class SimpleMRIRecon(Process):
    """``in_place=True`` is the paper-faithful pipeline (stages overwrite
    the input KData, as in listing 6).  ``in_place=False`` routes through a
    scratch KData so the input survives repeated launches.

    ``join=True`` takes the k-space and the sensitivity maps as SEPARATE
    inputs: ``"in"`` a kdata-only Data, ``in_handles["smaps"]`` the maps,
    which the internal ComplexElementProd (or FusedMRIRecon) consumes as
    its second input."""

    ports = {"in": Port(names=("kdata", "sensitivity_maps"),
                        dtype=np.complexfloating,
                        doc="multicoil K-space: kdata (F, C, H, W) + "
                            "sensitivity_maps (C, H, W)"),
             "out": Port(names=("xdata",),
                         doc="reconstructed x-images (F, H, W)")}

    def __init__(self, app=None, mode: str = "staged",
                 use_kernel: bool | str = "auto",
                 in_place: bool = True, join: bool = False):
        super().__init__(app)
        if mode not in ("staged", "fused", "fused_kernel"):
            raise ValueError(
                f"mode {mode!r}: expected 'staged' (one launch per stage), "
                "'fused' (stages run back to back, one arena write) or "
                "'fused_kernel' (the whole chain as one fused kernel)")
        self.mode = mode
        self.use_kernel = use_kernel
        self.in_place = in_place
        self.join = join
        self.chain: ProcessChain | None = None
        self._scratch: DataHandle = INVALID_HANDLE
        if join:
            self.ports = {
                "in": Port(names=("kdata",), dtype=np.complexfloating,
                           doc="multicoil K-space: kdata (F, C, H, W)"),
                "smaps": Port(dtype=np.complexfloating,
                              doc="sensitivity maps (C, H, W) as their own input"),
                "out": Port(names=("xdata",),
                            doc="reconstructed x-images (F, H, W)")}

    def out_specs(self, in_specs, aux_specs=None):
        k = in_specs["kdata"]
        return {"xdata": TensorSpec(tuple(k.shape[:-3]) + tuple(k.shape[-2:]), k.dtype)}

    def _scratch_handle(self) -> DataHandle:
        """The scratch arena of ``in_place=False``: allocated by the first
        ``init()`` and kept by later ones while the input's specs match."""
        app = self.getApp()
        specs = app.getData(self.in_handle).specs()
        if self._scratch != INVALID_HANDLE:
            if app.getData(self._scratch).specs() == specs:
                return self._scratch
            app.delData(self._scratch)
        self._scratch = app.addData(app.getData(self.in_handle).spec_clone())
        return self._scratch

    def init(self) -> None:
        self._validate_ports()
        if self.chain is not None:
            self.chain._release_stream()     # the former chain's stream twins
        app = self.getApp()
        smaps_h = self.in_handles.get("smaps") if self.join else None
        if self.mode == "fused_kernel":
            p_fused = FusedMRIRecon(app)
            p_fused.in_handle = self.in_handle
            p_fused.out_handle = self.out_handle
            if smaps_h is not None:
                p_fused.in_handles["smaps"] = smaps_h
            p_fused.set_launch_parameters(FusedReconParams(use_kernel=self.use_kernel))
            stages = [p_fused]
            chain_mode = "staged"
        else:
            work = self.in_handle if self.in_place else self._scratch_handle()

            p_ifft = FFT(app)
            p_ifft.in_handle = self.in_handle
            p_ifft.out_handle = work
            p_ifft.set_launch_parameters(FFTParams("backward", var="kdata"))

            p_prod = ComplexElementProd(app)
            p_prod.in_handle = work
            p_prod.out_handle = work                     # in place on scratch
            if smaps_h is not None:
                p_prod.in_handles["smaps"] = smaps_h
            p_prod.set_launch_parameters(ComplexElementProdParams(
                conjugate=True, use_kernel=self.use_kernel))

            p_sum = XImageSum(app)
            p_sum.in_handle = work
            p_sum.out_handle = self.out_handle
            p_sum.set_launch_parameters(CombineParams(use_kernel=self.use_kernel))
            stages = [p_ifft, p_prod, p_sum]
            chain_mode = self.mode
        self.chain = ProcessChain(app, stages, mode=chain_mode)
        self.chain.init()
        self._initialized = True

    def launch(self, profile: ProfileParameters | None = None) -> None:
        """The chain's launch: on the card its graph (``chain.captures``,
        ``chain.replays``; :meth:`Process.launch`)."""
        if not self._initialized:
            self.init()
        self.chain.launch(profile)

    def _stream_target(self) -> Process:
        """A stream (``stream()``, inherited: each item a KData, or with
        ``join=True`` an ``{"in": kdata, "smaps": maps}`` mapping) and a
        server launch the chain's twins, as the JAX package lowers this
        process to the chain's launchable."""
        if not self._initialized:
            self.init()
        return self.chain._stream_target()

