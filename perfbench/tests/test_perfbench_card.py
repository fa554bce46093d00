"""The cells at their own sizes on a CUDA card (marked ``card``; each test
skips without one): every cell of BENCHMARK.json runs correct for a short
window, and with its lower-precision control in the program's place it
comes out not correct on three seeds, while the program's own numbers
stay within the limits.

    python3 -m pytest -q -m card perfbench/tests/test_perfbench_card.py
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CONTROLS = {"cine160.resident": "bf16", "danube.train": "fp8"}


def need_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    need_card()
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                           str(2**31 + 101), "--seconds", "3", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    need_card()
    proc = subprocess.run([sys.executable, "perfbench/controls.py", "--workload", cell,
                           "--control", CONTROLS[cell], "--seconds", "2", "--seeds",
                           *(str(2**31 + 201 + i) for i in range(3))],
                          cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-4000:]
    limits = json.loads((ROOT / "perfbench/limits" / f"{cell}.json").read_text())["limits"]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"control_correct": [False] * 3}, proc.stdout[-4000:]
    readings = [json.loads(x) for x in lines if x.startswith('{"number"')]
    assert readings and all(r["program_max"] <= limits[r["number"]] for r in readings)
