"""BENCHMARK.json and the files it names: the keys, names, bounds and
files that the benchmark's contract asks for, each configuration, mix,
metric reader and limit found by name, and no module of the benchmark
that imports the JAX package or JAX."""
import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"] and b["paths"] == ["perfbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (bench()["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_configs_are_used_and_found():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []
        assert 1 <= len(c["why"]) <= 200 and c["source"].startswith("https://")
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])


def test_cells_name_their_files():
    b = bench()
    entries = b
    pairs = set()
    configs = {c["name"] for c in b["configs"]}
    for w in entries["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = json.loads((PKG / "traffic" / f"{w['traffic']}.json").read_text())
        assert (PKG / "drivers" / f"{mix['driver']}.py").is_file()
        limits = json.loads((PKG / "limits" / f"{w['name']}.json").read_text())["limits"]
        assert limits and all(v > 0 for v in limits.values())


def test_metrics_are_well_formed_and_read_by_name():
    b = bench()
    entries = b
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in entries["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", [])) <= cells
    layers = {}
    for m in entries["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["source"] in SOURCES
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    # every reader under metrics/ is a metric's, and every file under
    # traffic/ and limits/ a cell's
    assert {p.stem for p in (PKG / "metrics").glob("*.py")} == {m["name"] for m in b["per_layer"]}
    assert {p.stem for p in (PKG / "traffic").glob("*.json")} == {w["traffic"]
                                                                   for w in b["workloads"]}
    assert {p.stem for p in (PKG / "limits").glob("*.json")} == cells


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    from perfbench import harness
    b = harness.load_benchmark()
    for w in b["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(b, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(b, w["name"], "per_layer")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in PKG.rglob("*.py") if "tests" not in p.parts))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".", 1)[0] for m in _imports(ROOT / path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
    if path.startswith("perfbench/reference/"):
        assert "repro_torch" not in tops, path
    assert "benchmarks/" not in (ROOT / path).read_text(), path


def test_forbidden_modules_compares_whole_names():
    from perfbench import harness
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "flax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "cine160.resident",
                           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    if proc.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert "{" not in proc.stdout and "CUDA card" in proc.stderr


def test_a_fresh_run_loads_no_jax(tmp_path):
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}, {str(PKG / 'tests')!r}]\n"
        "from perfbench.tests.conftest import small\n"
        "from perfbench import harness\n"
        "config, mix = small('cine160.resident', {'stacks': 2})\n"
        "rc = harness.execute('cine160.resident', 7, 0.2, False, t_start=time.perf_counter(),\n"
        "                     device='cpu', config=config, mix=mix)\n"
        "print('rc', rc, sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "      ('jax', 'jaxlib', 'flax', 'repro')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                       "HOME": str(tmp_path)})
    assert proc.stdout.strip().splitlines()[-1] == "rc 0 []", proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-2])
    assert line["correct"] is True and not math.isnan(line["attempted"])
