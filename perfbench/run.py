#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once, from the repository's root:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are read from
``BENCHMARK.json`` and the files it names; the last line of standard output
is the result as one JSON object.  The program under test is the
PyTorch and CUDA package in ``src/``.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the repository's root (for ``perfbench``) and ``src`` (for the program),
# not this folder: its module names would shadow the standard library's
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
from perfbench.harness import main, set_cache_dirs  # noqa: E402

set_cache_dirs()

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
