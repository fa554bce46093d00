"""File readers/writers (paper §III-A.2d: common data formats out of the box).

OpenCLIPER reads/writes usual image formats (via DevIL) plus Matlab ``.mat``
and raw volumes.  The port's own copy of the JAX package's numpy-only
readers and writers, so that a file written by either package reads back
in the other (png, pgm, ppm and raw byte for byte):

* ``.npz`` / ``.npy`` — the Matlab-``.mat`` analogue (named variables)
* ``.png``            — pure-Python encoder/decoder (zlib), gray8/gray16/RGB8
* ``.pgm`` / ``.ppm`` — netpbm binary images
* ``.raw``            — raw volumes (dtype/shape sidecar JSON, as raw readers
                         traditionally require the geometry out of band)

numpy has no bfloat16 of its own, so no format here carries one: a raw
file whose sidecar says ``bfloat16`` is refused (``Data.save`` refuses a
bfloat16 Data, whose host copy is uint16 bit patterns, for the same
reason).

New formats plug in with :func:`register_format` — the analogue of
deriving a new reader class in OpenCLIPER.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np

#: the dtype name a bfloat16 array carries (``ml_dtypes``, the JAX package's)
BFLOAT16 = "bfloat16"

# ---------------------------------------------------------------------------
# npz / npy (the .mat analogue)
# ---------------------------------------------------------------------------

def load_npz(path: str, variables: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        names = list(variables) if variables else list(z.files)
        return {n: z[n] for n in names}


def save_npz(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


def load_npy(path: str, variables=None) -> Dict[str, np.ndarray]:
    return {"data": np.load(path)}


def save_npy(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    if len(arrays) != 1:
        raise ValueError(".npy stores exactly one array; use .npz")
    np.save(path, np.asarray(next(iter(arrays.values()))))


# ---------------------------------------------------------------------------
# PNG (pure python, no filtering on write; all 5 filters on read)
# ---------------------------------------------------------------------------
_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload)) + tag + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def save_png(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    if len(arrays) != 1:
        raise ValueError("PNG stores one image")
    img = np.asarray(next(iter(arrays.values())))
    if img.dtype in (np.float32, np.float64):
        img = np.clip(img, 0.0, 1.0)
        img = (img * 255.0 + 0.5).astype(np.uint8)
    if img.dtype == np.uint16:
        bitdepth = 16
    elif img.dtype == np.uint8:
        bitdepth = 8
    else:
        img = img.astype(np.uint8)
        bitdepth = 8
    if img.ndim == 2:
        color = 0  # grayscale
        rows = img[:, :, None]
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        color = 2 if img.shape[2] == 3 else 6
        rows = img
    else:
        raise ValueError(f"unsupported PNG shape {img.shape}")
    h, w, c = rows.shape
    if bitdepth == 16:
        payload_rows = rows.astype(">u2").tobytes()
        stride = w * c * 2
    else:
        payload_rows = rows.tobytes()
        stride = w * c
    raw = bytearray()
    for y in range(h):
        raw.append(0)  # filter type None
        raw.extend(payload_rows[y * stride : (y + 1) * stride])
    ihdr = struct.pack(">IIBBBBB", w, h, bitdepth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(bytes(raw), 6)))
        f.write(_png_chunk(b"IEND", b""))


def _png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), dtype=np.uint8)
    pos = 0
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        ftype = raw[pos]; pos += 1
        line = raw[pos : pos + stride].astype(np.int32); pos += stride
        if ftype == 0:
            rec = line
        elif ftype == 1:  # Sub
            rec = line.copy()
            for i in range(bpp, stride):
                rec[i] = (rec[i] + rec[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            rec = (line + prev) & 0xFF
        elif ftype == 3:  # Average
            rec = line.copy()
            for i in range(stride):
                left = rec[i - bpp] if i >= bpp else 0
                rec[i] = (rec[i] + ((left + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            rec = line.copy()
            for i in range(stride):
                a = int(rec[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                c = int(prev[i - bpp]) if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rec[i] = (rec[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[y] = rec.astype(np.uint8)
        prev = out[y]
    return out


def load_png(path: str, variables=None) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = bitdepth = color = None
    while pos < len(buf):
        (length,) = struct.unpack(">I", buf[pos : pos + 4])
        tag = buf[pos + 4 : pos + 8]
        payload = buf[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", payload)
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    itemsize = 2 if bitdepth == 16 else 1
    bpp = channels * itemsize
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(idat), dtype=np.uint8)
    flat = _png_unfilter(raw, h, stride, bpp)
    if bitdepth == 16:
        img = flat.reshape(h, w, channels, 2)
        img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
    else:
        img = flat.reshape(h, w, channels)
    if channels == 1:
        img = img[..., 0]
    return {"data": img}


# ---------------------------------------------------------------------------
# netpbm (PGM P5 / PPM P6)
# ---------------------------------------------------------------------------

def save_pnm(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    img = np.asarray(next(iter(arrays.values())))
    if img.dtype in (np.float32, np.float64):
        img = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    img = img.astype(np.uint8)
    if img.ndim == 2:
        magic, shape = b"P5", (img.shape[0], img.shape[1])
    elif img.ndim == 3 and img.shape[2] == 3:
        magic, shape = b"P6", (img.shape[0], img.shape[1])
    else:
        raise ValueError(f"unsupported PNM shape {img.shape}")
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (shape[1], shape[0]))
        f.write(img.tobytes())


def load_pnm(path: str, variables=None) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        buf = f.read()
    parts = buf.split(maxsplit=4)
    magic = parts[0]
    w, h, maxval = int(parts[1]), int(parts[2]), int(parts[3])
    data = parts[4] if len(parts) > 4 else b""
    dt = np.uint8 if maxval < 256 else np.dtype(">u2")
    arr = np.frombuffer(data, dtype=dt)
    if magic == b"P5":
        img = arr[: w * h].reshape(h, w)
    elif magic == b"P6":
        img = arr[: w * h * 3].reshape(h, w, 3)
    else:
        raise ValueError(f"unsupported PNM magic {magic!r}")
    return {"data": np.asarray(img)}


# ---------------------------------------------------------------------------
# raw volumes (+ JSON sidecar for geometry)
# ---------------------------------------------------------------------------

def save_raw(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    arr = np.asarray(next(iter(arrays.values())))
    arr.tofile(path)
    with open(path + ".json", "w") as f:
        json.dump({"shape": list(arr.shape), "dtype": arr.dtype.name}, f)


def load_raw(path: str, variables=None) -> Dict[str, np.ndarray]:
    sidecar = path + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
        if meta["dtype"] == BFLOAT16:
            raise ValueError(f"{path}: bfloat16 raw volumes are not read (numpy has no "
                             "bfloat16); write the volume as float32")
        arr = np.fromfile(path, dtype=np.dtype(meta["dtype"])).reshape(meta["shape"])
    else:
        arr = np.fromfile(path, dtype=np.uint8)
    return {"data": arr}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
_READERS: Dict[str, Callable] = {
    ".npz": load_npz, ".npy": load_npy, ".png": load_png,
    ".pgm": load_pnm, ".ppm": load_pnm, ".raw": load_raw,
}
_WRITERS: Dict[str, Callable] = {
    ".npz": save_npz, ".npy": save_npy, ".png": save_png,
    ".pgm": save_pnm, ".ppm": save_pnm, ".raw": save_raw,
}


def register_format(ext: str, reader: Callable | None, writer: Callable | None) -> None:
    """Plug in a new format (the paper: derive from the appropriate class)."""
    if reader:
        _READERS[ext] = reader
    if writer:
        _WRITERS[ext] = writer


def load_any(path: str, variables: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    ext = os.path.splitext(path)[1].lower()
    if ext not in _READERS:
        raise ValueError(f"no reader for {ext!r} (have {sorted(_READERS)})")
    return _READERS[ext](path, variables)


def save_any(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext not in _WRITERS:
        raise ValueError(f"no writer for {ext!r} (have {sorted(_WRITERS)})")
    bf16 = [k for k, v in arrays.items() if np.asarray(v).dtype.name == BFLOAT16]
    if bf16:
        raise ValueError(f"{path}: arrays {bf16} are bfloat16, which no format here "
                         "stores; convert them to float32 first")
    _WRITERS[ext](path, arrays)
