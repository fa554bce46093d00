"""Contiguous, aligned packing of heterogeneous array sets (paper §III-A.2).

OpenCLIPER guarantees that *"a single data set is always aligned and
contiguous, even though it is highly heterogeneous"* and that data objects
are *"transferred in a single call"* using pinned memory.  The **arena**
packs a set of N-D arrays of arbitrary shapes and dtypes into one
contiguous byte blob with a predictable offset table, every entry starting
on an ``ALIGN``-byte boundary.  One blob means one pinned host->device copy.

The byte format is shared with the JAX package: for the same specs,
:func:`pack_host` gives byte-identical blobs and identical offsets, so a
blob packed by either package unpacks in the other.  On the device, a view
is ``blob[off:off+n].view(dtype).view(shape)`` over a uint8 tensor:
zero-copy, so processes read and write the arena in place.

A batch of ``rows`` items of one layout (the streaming executor's unit)
lives in two forms: the **batched layout** (:func:`batched_layout`), each
entry with a leading ``rows`` axis, which a process launched on the whole
batch reads; and **stacked item blobs**, a ``(rows, total_bytes)`` array
whose row ``r`` is item ``r``'s own blob (:func:`stack_host_blobs`,
:func:`split_batched_blob`).  :func:`pack_rows` writes items into the
first form, :func:`unbatch_device` turns it into the second.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np
import torch

ALIGN = 128  # bytes: the arena format's entry alignment

#: the layout's name for bfloat16 entries, as the JAX package writes it.
#: numpy has no bfloat16 of its own (the JAX package gets one from
#: ``ml_dtypes``, which the port does not use), so a bfloat16 entry's host
#: bytes are held as uint16 bit patterns; on the device its view is
#: ``torch.bfloat16``.  A blob packed by either package unpacks in the other
#: with the same bytes at the same offsets.
BFLOAT16 = "bfloat16"

_TORCH_TO_NP = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64, torch.complex64: np.complex64,
    torch.complex128: np.complex128,
}
_NP_TO_TORCH = {np.dtype(v): k for k, v in _TORCH_TO_NP.items()}


def spec_dtype(dtype: Any) -> "np.dtype | str":
    """Canonical dtype of an array spec: a numpy dtype, or :data:`BFLOAT16`
    for torch's bfloat16, the name "bfloat16", or a numpy bfloat16 dtype
    from ``ml_dtypes`` (the JAX package's arrays)."""
    if isinstance(dtype, torch.dtype):
        return BFLOAT16 if dtype == torch.bfloat16 else np.dtype(_TORCH_TO_NP[dtype])
    if isinstance(dtype, str) and dtype == BFLOAT16:
        return BFLOAT16
    nd = np.dtype(dtype)
    return BFLOAT16 if nd.name == BFLOAT16 else nd


def is_bfloat16(dtype: Any) -> bool:
    return isinstance(spec_dtype(dtype), str)


def dtype_name(dtype: Any) -> str:
    """The layout's name of a dtype ("float32", "bfloat16", ...)."""
    d = spec_dtype(dtype)
    return d if isinstance(d, str) else d.name


def np_dtype(dtype: Any) -> np.dtype:
    """numpy dtype that holds a spec's host bytes (uint16 for bfloat16)."""
    d = spec_dtype(dtype)
    return np.dtype(np.uint16) if isinstance(d, str) else d


def torch_dtype(dtype: Any) -> torch.dtype:
    """torch dtype of a numpy/torch dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    d = spec_dtype(dtype)
    return torch.bfloat16 if isinstance(d, str) else _NP_TO_TORCH[d]


def host_array(value: Any, dtype: Any) -> np.ndarray:
    """``value`` (numpy array, torch tensor or nested list) as a numpy array
    holding ``dtype``'s host bytes.  For bfloat16: 2-byte values (uint16
    bits, or ``ml_dtypes`` bfloat16) are taken bit for bit, anything else
    is rounded to bfloat16 (to nearest even, torch's conversion)."""
    if not is_bfloat16(dtype):
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        return np.asarray(value).astype(np_dtype(dtype), copy=False)
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype != torch.bfloat16:
            t = t.float().to(torch.bfloat16)
        return t.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(value)
    if a.dtype.itemsize == 2 and (a.dtype == np.uint16 or a.dtype.name == BFLOAT16):
        return a.view(np.uint16)
    return host_array(torch.from_numpy(np.asarray(a, np.float32)), BFLOAT16)


def _round_up(n: int, align: int = ALIGN) -> int:
    return (n + align - 1) // align * align


@dataclasses.dataclass(frozen=True)
class ArenaEntry:
    """Placement of one logical array inside the arena blob."""

    name: str
    shape: Tuple[int, ...]
    dtype: str           # dtype name, e.g. "float32", "complex64", "bfloat16"
    offset: int          # byte offset into the blob (ALIGN-aligned)
    nbytes: int          # payload bytes (not including alignment padding)

    @property
    def np_dtype(self) -> np.dtype:
        """numpy dtype of the entry's host bytes (uint16 for bfloat16)."""
        return np_dtype(self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class ArenaLayout:
    """Immutable offset table for a packed arena."""

    entries: Tuple[ArenaEntry, ...]
    total_bytes: int

    def __post_init__(self):
        names = [e.name for e in self.entries]
        if len(set(names)) != len(names):
            raise ValueError("duplicate names in arena layout")

    @property
    def names(self) -> List[str]:
        return [e.name for e in self.entries]

    def entry(self, name: str) -> ArenaEntry:
        for e in self.entries:
            if e.name == name:
                return e
        raise KeyError(name)

    def to_json(self) -> str:
        return json.dumps({
            "total_bytes": self.total_bytes,
            "entries": [dataclasses.asdict(e) for e in self.entries],
        })

    @staticmethod
    def from_json(text: str) -> "ArenaLayout":
        obj = json.loads(text)
        entries = tuple(
            ArenaEntry(name=e["name"], shape=tuple(e["shape"]),
                       dtype=e["dtype"], offset=e["offset"],
                       nbytes=e["nbytes"])
            for e in obj["entries"])
        return ArenaLayout(entries=entries, total_bytes=obj["total_bytes"])


def plan_layout(specs: Iterable[Tuple[str, Sequence[int], Any]]) -> ArenaLayout:
    """Compute an aligned layout for ``(name, shape, dtype)`` specs, placed
    in the given order, each entry rounded up to ``ALIGN`` bytes."""
    entries: List[ArenaEntry] = []
    offset = 0
    for name, shape, dtype in specs:
        # np.prod of an empty shape is 1, so 0-d scalars get one item
        nbytes = int(np.prod(tuple(shape), dtype=np.int64)) * np_dtype(dtype).itemsize
        entries.append(ArenaEntry(
            name=str(name), shape=tuple(int(s) for s in shape),
            dtype=dtype_name(dtype), offset=offset, nbytes=int(nbytes)))
        offset += _round_up(max(int(nbytes), 1))
    return ArenaLayout(entries=tuple(entries), total_bytes=offset)


# ---------------------------------------------------------------------------
# Host side (numpy; zero-copy views on unpack)
# ---------------------------------------------------------------------------

def pack_host(arrays: Mapping[str, Any],
              layout: ArenaLayout | None = None) -> Tuple[np.ndarray, ArenaLayout]:
    """Pack named host arrays into one contiguous uint8 blob.  Without a
    layout, each entry takes its array's dtype (a uint16 array stays uint16;
    give a layout, or a torch bfloat16 tensor, for a bfloat16 entry)."""
    if layout is None:
        layout = plan_layout(
            (k, tuple(v.shape), v.dtype if isinstance(v, torch.Tensor) else np.asarray(v).dtype)
            for k, v in arrays.items())
    blob = np.zeros(layout.total_bytes, dtype=np.uint8)
    for e in layout.entries:
        a = host_array(arrays[e.name], e.dtype)
        if tuple(a.shape) != e.shape:
            raise ValueError(f"{e.name}: shape {a.shape} != layout {e.shape}")
        raw = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        blob[e.offset: e.offset + e.nbytes] = raw
    return blob, layout


def unpack_host(blob: np.ndarray, layout: ArenaLayout) -> Dict[str, np.ndarray]:
    """Zero-copy views of each entry out of a host blob (bfloat16 entries
    as uint16 bit patterns)."""
    return {e.name: blob[e.offset: e.offset + e.nbytes].view(e.np_dtype)
            .reshape(e.shape) for e in layout.entries}


# ---------------------------------------------------------------------------
# Trees of arrays (nested dicts; the checkpoints of repro_torch.ckpt)
# ---------------------------------------------------------------------------

def tree_flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr path, leaf)]`` of a nested dict, keys sorted: the order
    JAX flattens a dict in, each leaf named by its key path the way
    ``jax.tree_util.keystr`` names it (``['layers']['attn']['w_q']``)."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out += tree_flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    return [(prefix, tree)]


def tree_unflatten(flat: Iterable[Tuple[str, Any]]) -> Dict[str, Any]:
    """The nested dict of ``[(keystr path, leaf)]`` (string keys): the
    inverse of :func:`tree_flatten`."""
    out: Dict[str, Any] = {}
    for name, leaf in flat:
        node, keys = out, name[2:-2].split("']['")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return out


def pack_tree_host(tree: Any) -> Tuple[np.ndarray, ArenaLayout]:
    """Pack a nested dict of host arrays (numpy, or CPU tensors: a bfloat16
    tensor becomes a bfloat16 entry) into one blob, each leaf an entry
    named by its key path: the JAX package's ``pack_tree_host`` layout."""
    return pack_host(dict(tree_flatten(tree)))


def unpack_tree_host(blob: np.ndarray, layout: ArenaLayout, treedef_like: Any) -> Any:
    """The nested dict laid out as ``treedef_like`` from a blob: its
    leaves are the entries of their key paths (views into ``blob``;
    bfloat16 entries as uint16 bit patterns)."""
    named = unpack_host(blob, layout)
    return tree_unflatten((name, named[name]) for name, _ in tree_flatten(treedef_like))


# ---------------------------------------------------------------------------
# Device side (torch; zero-copy views into a uint8 blob)
# ---------------------------------------------------------------------------

def device_view(blob: torch.Tensor, entry: ArenaEntry) -> torch.Tensor:
    """Zero-copy view of one entry of a uint8 blob on any torch device."""
    raw = blob[entry.offset: entry.offset + entry.nbytes]
    return raw.view(entry.torch_dtype).view(entry.shape)


def unpack_device(blob: torch.Tensor, layout: ArenaLayout) -> Dict[str, torch.Tensor]:
    return {e.name: device_view(blob, e) for e in layout.entries}


def pack_device(arrays: Mapping[str, torch.Tensor], layout: ArenaLayout,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Write named tensors into a uint8 blob (``out``, or a new zeroed blob
    on the first array's device).  An array that already IS the blob's view
    of its entry (a kernel wrote into the arena in place) is not copied."""
    if out is None:
        device = next(iter(arrays.values())).device if arrays else "cpu"
        out = torch.zeros(layout.total_bytes, dtype=torch.uint8, device=device)
    for e in layout.entries:
        dst = device_view(out, e)
        src = arrays[e.name]
        if src.data_ptr() == dst.data_ptr() and src.dtype == dst.dtype \
                and tuple(src.shape) == e.shape and src.is_contiguous():
            continue
        dst.copy_(src.reshape(e.shape))
    return out


# ---------------------------------------------------------------------------
# Batches: k items of one layout (streaming)
# ---------------------------------------------------------------------------

def batched_layout(layout: ArenaLayout, rows: int) -> ArenaLayout:
    """The layout of ``rows`` items of ``layout`` with each entry stacked on
    a leading axis (entry ``name`` of shape ``(rows,) + shape``): what a
    process launched once for the whole batch reads.  The counterpart of
    the JAX package's ``batched_spec``, whose vmapped program reads
    stacked item blobs instead."""
    return plan_layout((e.name, (int(rows),) + e.shape, e.dtype) for e in layout.entries)


def stack_host_blobs(blobs: Sequence[np.ndarray], layout: ArenaLayout) -> np.ndarray:
    """Per-item host blobs as one contiguous ``(k, total_bytes)`` array,
    each checked against ``layout``."""
    for b in blobs:
        if b.shape != (layout.total_bytes,) or b.dtype != np.uint8:
            raise ValueError(f"blob shape {b.shape}/{b.dtype} does not match layout "
                             f"({layout.total_bytes},)/uint8")
    return np.stack(blobs, axis=0)


def split_batched_blob(stacked: torch.Tensor) -> List[torch.Tensor]:
    """Per-item 1-D blobs (views, no copy) of a ``(k, total_bytes)`` stack."""
    return [stacked[r] for r in range(int(stacked.shape[0]))]


def carve_rows(stacked: Any, split: Sequence[int]) -> List[Any]:
    """``stacked`` (a ``(rows, total_bytes)`` host or device blob, or any
    sequence of rows) cut by a split vector: part ``j`` is rows
    ``sum(split[:j])`` to ``sum(split[:j+1])``, a view (a slice of the
    list), never a copy.  The parts cover every row in order."""
    if sum(split) != len(stacked):
        raise ValueError(f"split vector {tuple(split)} covers {sum(split)} rows, the stack "
                         f"has {len(stacked)}")
    parts, off = [], 0
    for c in split:
        parts.append(stacked[off:off + c])
        off += c
    return parts


def pack_rows(dst: np.ndarray, batched: ArenaLayout,
              items: Sequence[Mapping[str, np.ndarray] | None]) -> None:
    """Write item ``r``'s arrays (``{name -> host array}``) into row ``r``
    of every entry of the host buffer ``dst`` (uint8, ``batched``'s bytes);
    a row whose item is None is left as it is."""
    for e in batched.entries:
        rows = dst[e.offset: e.offset + e.nbytes].reshape(len(items), -1)
        for r, arrays in enumerate(items):
            if arrays is not None:
                rows[r] = np.ascontiguousarray(arrays[e.name]).view(np.uint8).reshape(-1)


def unbatch_device(blob: torch.Tensor, batched: ArenaLayout, item: ArenaLayout,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """A batched-layout device blob as stacked item blobs: a new
    ``(rows, item.total_bytes)`` tensor (or ``out``), row ``r`` holding
    item ``r``'s blob; one strided copy an entry.  Alignment padding
    between entries is zero."""
    rows = batched.entries[0].shape[0] if batched.entries else 0
    if out is None:
        payload = sum(e.nbytes for e in item.entries)
        make = torch.empty if payload == item.total_bytes else torch.zeros
        out = make((rows, item.total_bytes), dtype=torch.uint8, device=blob.device)
    for e_item, e_b in zip(item.entries, batched.entries):
        src = blob[e_b.offset: e_b.offset + e_b.nbytes].view(rows, e_item.nbytes)
        out[:, e_item.offset: e_item.offset + e_item.nbytes].copy_(src)
    return out
