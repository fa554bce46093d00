"""Build and load the hand-written CUDA kernels.

Every source under ``csrc/`` is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into ONE shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the build
takes seconds).  The library lands in ``build/repro_torch/`` at the
repository root, named by a hash of the sources and flags: a checkout
builds it at first use, and a changed source builds a new one.  Nothing
here runs at import time.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared", "-gencode", "arch=compute_90a,code=sm_90a")

_LIB: Optional[ctypes.CDLL] = None
#: what the last build (or cache hit) reported: path, seconds, nvcc log
BUILD_INFO: dict = {}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "rt_cprod": (_P, _P, _P, _LL, _LL, _LL, _I, _P),
    "rt_coil_combine": (_P, _P, _I, _LL, _I, _LL, _P),
    "rt_fused_epilogue": (_P, _P, _P, _I, _LL, _I, _LL, _LL, _P),
    "rt_dft_recon": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "rt_rmsnorm": (_P, _P, _P, _LL, _I, _I, _I, _F, _P),
    "rt_rmsnorm_bwd": (_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _P),
    "rt_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "rt_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _F, _I, _P),
    "rt_wkv6": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "rt_wkv6_bwd": (_P,) * 17 + (_I, _I, _I, _I, _I, _P),
    "rt_negate": (_P, _P, _LL, _I, _P),
    "rt_adamw_update": (_P,) * 5 + (_LL, _I, _I) + (_P,) * 4 + (_F,) * 6 + (_P,),
    "rt_sumsq_partial": (_P, _LL, _I, _P, _I, _P),
    "rt_sumsq_final": (_P, _I, _I, _P, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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
    out = BUILD_DIR / f"librepro_kernels_{source_hash()}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True,
                          log=log_path.read_text() if log_path.exists() else "")
        return out
    work = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    log, failed = "", False
    for cmd, proc in jobs:
        output, _ = proc.communicate()
        log += f"$ {' '.join(cmd)}\n{output}"
        failed |= proc.returncode != 0
    if not failed:
        tmp = work / out.name
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(work / f"{p.stem}.o") for p in sources())]
        r = subprocess.run(cmd, capture_output=True, text=True)
        log += f"$ {' '.join(cmd)}\n{r.stdout}{r.stderr}"
        failed = r.returncode != 0
    seconds = time.perf_counter() - t0
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise KernelCompileError("repro_torch.kernels.csrc", log)
    log_path.write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    shutil.rmtree(work, ignore_errors=True)
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
