"""Heterogeneous data containers (paper §III-B: Data / NDArray / Concrete*).

The paper's ``Data`` -> ``NDArray`` -> ``ConcreteNDArray`` split collapses
into :class:`NDArray` (a numpy host buffer and/or a shape/dtype spec); the
*structure* — a Data set holding many differently-shaped, differently-typed
arrays that moves to and from the device as ONE contiguous buffer — is kept
through :mod:`repro_torch.core.arena`.

Out-of-the-box specialisations, as in the paper:

* :class:`XData` — data with direct physical interpretation (images, volumes)
* :class:`KData` — complex K-space data + per-coil sensitivity maps
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data import io
from .arena import (ArenaLayout, host_array, is_bfloat16, pack_host, plan_layout, spec_dtype,
                    unpack_device, unpack_host)
from .sync import Coherence, SyncSource, resolve_source


class TensorSpec(NamedTuple):
    """Shape and dtype of one array (what ports check): a numpy dtype, or
    ``"bfloat16"`` (:data:`~repro_torch.core.arena.BFLOAT16`)."""

    shape: Tuple[int, ...]
    dtype: Any


class NDArray:
    """A signal/image/volume of one dtype: host-backed or spec-only.  The
    host copy of a bfloat16 array holds its uint16 bit patterns."""

    def __init__(self, value: Any = None, *, shape: Sequence[int] | None = None,
                 dtype: Any = None, name: str | None = None):
        if value is not None:
            if dtype is None:
                dtype = value.dtype if isinstance(value, torch.Tensor) else np.asarray(value).dtype
            self.dtype = spec_dtype(dtype)
            self._host: Optional[np.ndarray] = host_array(value, self.dtype)
            self.shape: Tuple[int, ...] = tuple(self._host.shape)
        else:
            if shape is None or dtype is None:
                raise ValueError("spec-only NDArray needs shape and dtype")
            self._host = None
            self.shape = tuple(int(s) for s in shape)
            self.dtype = spec_dtype(dtype)
        self.name = name

    @property
    def host(self) -> Optional[np.ndarray]:
        return self._host

    def set_host(self, value: Any) -> None:
        value = host_array(value, self.dtype)
        if tuple(value.shape) != self.shape:
            raise ValueError(f"shape mismatch {value.shape} != {self.shape}")
        self._host = value

    def spec(self) -> TensorSpec:
        return TensorSpec(self.shape, self.dtype)

    def __repr__(self):
        kind = "host" if self._host is not None else "spec"
        return f"NDArray<{kind}>({self.name or ''}, shape={self.shape}, dtype={self.dtype})"


class Data:
    """A set of :class:`NDArray` objects moved to/from the device as a unit:
    one arena blob (``device_blob``, a uint8 tensor) with a predictable
    layout and explicit host/device coherence.

    ``persistent`` marks state that lives on the device across launches (a
    decode cache bound as both the input and the output of a step): the
    Pipeline plans it device-resident (``residency == "device"``) even on
    a graph input/output edge, each write stamps it
    ``Coherence.DEVICE_RESIDENT``, and nothing syncs it to the host, so a
    spec-only persistent Data never grows a host mirror."""

    def __init__(self, arrays: Sequence[NDArray] | Mapping[str, Any] | None = None):
        self._arrays: List[NDArray] = []
        if isinstance(arrays, Mapping):
            for k, v in arrays.items():
                a = v if isinstance(v, NDArray) else NDArray(v)
                a.name = k
                self._arrays.append(a)
        elif arrays is not None:
            for i, a in enumerate(arrays):
                a = a if isinstance(a, NDArray) else NDArray(a)
                if a.name is None:
                    a.name = f"nd{i}"
                self._arrays.append(a)
        self.layout: Optional[ArenaLayout] = None
        self.device_blob: Optional[torch.Tensor] = None
        self.coherence = self._host_coherence()
        #: 'host' (pinned host path) or 'device' (stays on the device);
        #: set by ``Pipeline.build`` on edge Data
        self.residency: str = "host"
        self.persistent: bool = False

    def _host_coherence(self) -> Coherence:
        # HOST_FRESH only when every array is host-backed; spec-only sets
        # have nothing authoritative to read yet
        if self._arrays and all(a.host is not None for a in self._arrays):
            return Coherence.HOST_FRESH
        return Coherence.EMPTY

    # -- container protocol ---------------------------------------------------
    def add(self, array: NDArray) -> None:
        if array.name is None:
            array.name = f"nd{len(self._arrays)}"
        self._arrays.append(array)
        if self.device_blob is None:
            self.coherence = self._host_coherence()

    def get_ndarray(self, i: int) -> NDArray:
        return self._arrays[i]

    def __len__(self) -> int:
        return len(self._arrays)

    def __iter__(self):
        return iter(self._arrays)

    @property
    def names(self) -> List[str]:
        return [a.name for a in self._arrays]

    # -- construction helpers ---------------------------------------------------
    @classmethod
    def from_specs(cls, specs: Mapping[str, TensorSpec]) -> "Data":
        """Spec-only Data from ``{name -> TensorSpec}`` (the inverse of
        :meth:`specs`): how the Pipeline allocates its edge Data."""
        d = cls(None)
        for name, s in specs.items():
            d.add(NDArray(shape=s.shape, dtype=s.dtype, name=name))
        return d

    @classmethod
    def from_layout(cls, layout: ArenaLayout) -> "Data":
        """Spec-only Data of ``layout``'s entries, planned to that layout:
        what a streamed or served result is, before its device blob is
        attached."""
        d = cls(None)
        for e in layout.entries:
            d.add(NDArray(shape=e.shape, dtype=e.dtype, name=e.name))
        d.layout = layout
        return d

    def spec_clone(self) -> "Data":
        """Same-shaped, spec-only copy: a scratch or output Data the size
        of this one."""
        d = Data(None)
        for a in self._arrays:
            d.add(NDArray(shape=a.shape, dtype=a.dtype, name=a.name))
        d.layout = self.layout
        return d

    # -- layout / packing -------------------------------------------------------
    def plan(self) -> ArenaLayout:
        self.layout = plan_layout((a.name, a.shape, a.dtype) for a in self._arrays)
        return self.layout

    def pack_host(self) -> np.ndarray:
        if self.layout is None:
            self.plan()
        missing = [a.name for a in self._arrays if a.host is None]
        if missing:
            raise ValueError(f"cannot pack spec-only arrays: {missing}")
        blob, _ = pack_host({a.name: a.host for a in self._arrays}, self.layout)
        return blob

    # -- device views -------------------------------------------------------------
    def device_views(self) -> Dict[str, torch.Tensor]:
        if self.device_blob is None or self.layout is None:
            raise ValueError("Data not registered on a device (use CLapp.addData)")
        return unpack_device(self.device_blob, self.layout)

    def device_view(self, name_or_idx) -> torch.Tensor:
        views = self.device_views()
        if isinstance(name_or_idx, int):
            return views[self._arrays[name_or_idx].name]
        return views[name_or_idx]

    # -- host sync -------------------------------------------------------------------
    def sync_to_host(self) -> None:
        """Copy the device blob back into the host NDArrays (paper's
        ``device2Host``).  The host arrays never alias the device blob."""
        if self.device_blob is None or self.layout is None:
            raise ValueError("no device buffer to sync from")
        blob = self.device_blob.detach()
        host = blob.numpy().copy() if blob.device.type == "cpu" else blob.cpu().numpy()
        views = unpack_host(host, self.layout)
        for a in self._arrays:
            a.set_host(views[a.name])
        self.coherence = Coherence.IN_SYNC

    def authoritative(self, sync: SyncSource = SyncSource.AUTO) -> str:
        """``"host"`` or ``"device"``: which copy a read takes under ``sync``."""
        return resolve_source(sync, self.coherence)

    def specs(self) -> Dict[str, TensorSpec]:
        return {a.name: a.spec() for a in self._arrays}

    # -- IO (paper: file formats out of the box) ---------------------------------
    def save(self, path: str, sync: SyncSource = SyncSource.AUTO) -> None:
        """Write the arrays to ``path`` in the format its extension names
        (:mod:`repro_torch.data.io`).  With ``AUTO`` a Data whose device
        copy is the newer one (a launch wrote it, eagerly or by a replayed
        graph; or it is device-resident) is synced first, so a stale host
        copy is never written.  A bfloat16 array is refused: its host copy
        is uint16 bit patterns, and no format here stores bfloat16."""
        bf16 = [a.name for a in self._arrays if is_bfloat16(a.dtype)]
        if bf16:
            raise ValueError(f"cannot save {path}: arrays {bf16} are bfloat16, which no "
                             "file format of the port stores; convert them to float32")
        if self.authoritative(sync) == "device":
            self.sync_to_host()
        missing = [a.name for a in self._arrays if a.host is None]
        if missing:
            raise ValueError(f"cannot save {path}: arrays {missing} have no host values")
        io.save_any(path, {a.name: a.host for a in self._arrays})

    def matlab_save(self, path: str, var: str | None = None,
                    sync: SyncSource = SyncSource.AUTO) -> None:
        """Save in the .mat-analogue container (npz); ``var`` is accepted
        for the paper's signature, the arrays keep their own names."""
        self.save(path if path.endswith(".npz") else path + ".npz", sync)

    @classmethod
    def load(cls, path: str, variables: Sequence[str] | None = None) -> "Data":
        """A Data of the arrays in ``path`` (``variables``: only those, by name)."""
        return cls(io.load_any(path, variables))

    def __repr__(self):
        return f"{type(self).__name__}({', '.join(map(repr, self._arrays))})"


class XData(Data):
    """Data with a direct physical interpretation (images, volumes).

    ``src`` is a file path (read with :func:`repro_torch.data.io.load_any`,
    converted to ``dtype`` when one is given), another Data (its arrays
    copied, or with ``copy_values=False`` spec-only arrays of the same
    names, shapes and dtypes: "an output the size of the input", listing
    1), or arrays as :class:`Data` takes them (also as ``arrays=``)."""

    def __init__(self, src: Any = None, copy_values: bool = True, dtype: Any = None,
                 arrays: Sequence[NDArray] | Mapping[str, Any] | None = None):
        if isinstance(src, (str, os.PathLike)):
            loaded = io.load_any(os.fspath(src))
            if dtype is not None:
                loaded = {k: NDArray(v, dtype=dtype) for k, v in loaded.items()}
            super().__init__(loaded)
        elif isinstance(src, Data):
            if copy_values:
                super().__init__([NDArray(np.array(a.host), dtype=a.dtype, name=a.name)
                                  for a in src])
            else:
                super().__init__([NDArray(shape=a.shape, dtype=a.dtype, name=a.name)
                                  for a in src])
        else:
            super().__init__(arrays if arrays is not None else src)


class KData(Data):
    """Complex K-space data + sensitivity maps (paper §IV-A): ``kdata``
    (frames, coils, H, W) and ``sensitivity_maps`` (coils, H, W).

    ``src`` is a mapping with those two names, or a file path: then
    ``variables`` names the file's (k-space, maps) variables, in that
    order (default the canonical names)."""

    KDATA = "kdata"
    SMAPS = "sensitivity_maps"

    def __init__(self, src: Any = None, variables: Sequence[str] | None = None):
        if isinstance(src, (str, os.PathLike)):
            names = list(variables or [self.KDATA, self.SMAPS])
            if len(names) != 2:
                raise ValueError(f"KData needs exactly (kdata, smaps) variables, got {names}")
            loaded = io.load_any(os.fspath(src), names)
            # indexed by the REQUESTED names, never by the reader's order (a
            # reader may return the file's order, which would swap the two)
            missing = [n for n in names if n not in loaded]
            if missing:
                raise KeyError(f"variables {missing} not found in {os.fspath(src)!r} "
                               f"(loaded: {sorted(loaded)})")
            super().__init__({self.KDATA: loaded[names[0]], self.SMAPS: loaded[names[1]]})
        elif isinstance(src, Mapping):
            super().__init__({self.KDATA: src[self.KDATA], self.SMAPS: src[self.SMAPS]})
        else:
            super().__init__(src)

    @property
    def kdata(self) -> NDArray:
        return self._arrays[self.names.index(self.KDATA)]

    @property
    def smaps(self) -> NDArray:
        return self._arrays[self.names.index(self.SMAPS)]

    @property
    def n_coils(self) -> int:
        return self.kdata.shape[-3]

    @property
    def n_frames(self) -> int:
        return self.kdata.shape[0]

    def x_shape(self) -> Tuple[int, ...]:
        """Shape of the reconstructed X-space image set (frames, H, W)."""
        f, _, h, w = self.kdata.shape
        return (f, h, w)
