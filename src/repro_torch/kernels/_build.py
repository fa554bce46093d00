"""Build and load the hand-written CUDA kernels.

All sources under ``csrc/`` go through ONE ``nvcc`` call into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so the build takes seconds).  The library lands in
``build/repro_torch/`` at the repository root, named by a hash of the
sources and flags: a checkout builds it at first use, and a changed source
builds a new one.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

from repro_torch.core.registry import KernelCompileError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: Optional[ctypes.CDLL] = None
#: what the last build (or cache hit) reported: path, seconds, nvcc log
BUILD_INFO: dict = {}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "rt_cprod": (_P, _P, _P, _LL, _LL, _I, _P),
    "rt_coil_combine": (_P, _P, _I, _LL, _I, _LL, _P),
    "rt_fused_epilogue": (_P, _P, _P, _I, _LL, _I, _LL, _P),
    "rt_dft_recon": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelCompileError("repro_torch.kernels.csrc",
                             "nvcc not found on PATH or in the CUDA toolkit")


def build() -> Path:
    """Compile the sources (unless this hash is built already); return the
    library's path."""
    out = BUILD_DIR / f"libmri_kernels_{source_hash()}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True,
                          log=log_path.read_text() if log_path.exists() else "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = f"$ {' '.join(cmd)}\n{r.stdout}{r.stderr}"
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelCompileError("repro_torch.kernels.csrc", log)
    log_path.write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    BUILD_INFO.update(path=str(out), seconds=seconds, cached=False, log=log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = library().rt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} ({msg})")
