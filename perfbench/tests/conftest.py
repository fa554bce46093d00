"""Fixtures of the benchmark's own tests: the cells at sizes a CPU test
run can hold, and the ``card`` marker of the tests that need a CUDA card
(each decides inside the test whether there is one)."""
import io
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


#: the decoder at a width a CPU run holds (the published layout, fewer and
#: narrower layers)
SMALL_DECODER = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                     vocab=128)
SMALL_MRI = dict(frames=2, coils=3, height=24, width=20)


def small(cell: str, mix_changes: dict | None = None):
    """(config, mix) of ``cell`` at a CPU test's size."""
    from perfbench import harness
    from perfbench.mixes import load_mix
    bench = harness.load_benchmark()
    w = harness.find(bench["workloads"], cell, "workload")
    config = harness.load_config(harness.find(bench["configs"], w["config"], "configuration"))
    config.update(SMALL_MRI if "frames" in config else SMALL_DECODER)
    mix = load_mix(w["traffic"])
    mix.update(mix_changes or {})
    return config, mix


def run_small(cell: str, limits: dict, mix_changes: dict | None = None, seconds: float = 0.5,
              seed: int = 2**31 + 5, control: str | None = None, trace: bool = False):
    """One run of ``cell`` on the CPU at a test's size: (exit code, result
    line as a dict, standard error)."""
    from perfbench import harness
    config, mix = small(cell, mix_changes)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.execute(cell, seed, seconds, trace, t_start=time.perf_counter(), device="cpu",
                         config=config, mix=mix, limits=limits, control=control, forbid=False,
                         out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture
def cpu_run():
    return run_small
