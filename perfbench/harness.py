"""The benchmark's run of one cell: find the cell, its configuration, its
traffic mix and its driver by name, check for the cards, run the driver,
read the per-layer metrics with their readers, and print the result line.

A driver (``perfbench/drivers/<mix's driver>.py``) has one function,
``run(run: Run) -> dict``, which sets up, calls :meth:`Run.open_window`,
measures for ``run.seconds``, closes the window with
:meth:`Run.close_window`, reads the memory peak, frees the program's state
and checks what the timed path produced against the plain reference.  It
returns the end-to-end metrics, ``attempted``, ``failed``, the compared
numbers with their limits (``checks``) and the peak; with a control
(``run.control``), ``checks`` holds the control's numbers in the
program's place and ``program`` the program's own.

A per-layer metric is ``perfbench/metrics/<name>.py`` with one function,
``read(run: Run) -> float | None``; None leaves the metric out.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from perfbench import yardstick
from perfbench.mixes import load_mix

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
#: where a traced run writes its trace while it reads it (the file is removed)
SCRATCH = ROOT / ".perfbench"
#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, set
    before torch is imported; and no JAX behind a library that would load it."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}")


def load_config(entry: Dict, root: Path = ROOT) -> Dict:
    return json.loads((root / entry["file"]).read_text())


def load_limits(cell: str, root: Path = ROOT) -> Dict[str, float]:
    """The cell's limits (``perfbench/limits/<cell>.json``)."""
    return json.loads((root / "perfbench" / "limits" / f"{cell}.json").read_text())["limits"]


def forbidden_modules(names=None) -> List[str]:
    """Top-level names among ``names`` (the loaded modules by default) that
    the benchmark may not load, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def metric_reader(name: str):
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r}: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``kind`` (``end_to_end`` or ``per_layer``) metrics the cell
    reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


class Run:
    """One run of one cell: its settings, the window, the host spans and
    counters, and (with ``trace``) the device activity of the traced part
    of the window."""

    def __init__(self, cell: Dict, config: Dict, mix: Dict, seed: int, seconds: float,
                 trace: bool, device, t_start: float, control: Optional[str] = None):
        self.cell, self.config, self.mix = cell, config, mix
        #: the control put in the program's place for the check: the
        #: reference in a lower precision, or with a planted fault
        #: (``perfbench/controls.py``); None in a benchmark run
        self.control = control
        #: the limit of each compared number (``perfbench/limits/<cell>.json``)
        self.limits: Dict[str, float] = {}
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.t_start = device, t_start
        self.setup_s: Optional[float] = None
        self.window: Optional[tuple] = None          # host perf_counter (start, end)
        self.spans: Dict[str, List[tuple]] = {}
        self.counters: Dict[str, float] = {}
        self.events: List[tuple] = []                # device (cat, name, start us, end us)
        self.annotations: List[tuple] = []           # host spans in the trace's clock
        self.trace_window: Optional[tuple] = None    # (start us, end us) in the trace's clock
        self.trace_host: Optional[tuple] = None      # the same in host perf_counter
        self._prof = None

    # -- spans and counters ------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        """A host span around a call into the program, on the host clock
        alone."""
        t0 = time.perf_counter()
        yield
        self.spans.setdefault(name, []).append((t0, time.perf_counter()))

    def mark(self, name: str):
        """While tracing, a ``record_function`` range, so that the trace's
        idle gaps name what the host was doing; otherwise nothing.  Put it
        around a pass or a step, not around each call: the range costs the
        host time."""
        if self._prof is None:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(f"perfbench.{name}")

    def spans_in(self, name: str, lo: float, hi: float) -> List[tuple]:
        return [(a, b) for a, b in self.spans.get(name, ()) if a >= lo and b <= hi]

    # -- the window ------------------------------------------------------------------
    def trace_seconds(self) -> float:
        return min(self.seconds, float(self.mix.get("trace_seconds", self.seconds)))

    def open_window(self) -> float:
        """Ends set-up; starts the profiler in a traced run.  Returns the
        window's start on the host clock."""
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        if self.trace:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            with torch.profiler.record_function("perfbench.trace_start"):
                pass
            self._trace_t0 = time.perf_counter()
        self.window = (time.perf_counter(), None)
        return self.window[0]

    def stop_trace(self) -> None:
        """Stops the profiler (in a traced run, once its part of the window
        has passed) and reads the device activity from its trace."""
        if self._prof is None:
            return
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with torch.profiler.record_function("perfbench.trace_end"):
            pass
        t1 = time.perf_counter()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        SCRATCH.mkdir(exist_ok=True)
        path = SCRATCH / f"trace.{os.getpid()}.json"
        try:
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        finally:
            path.unlink(missing_ok=True)
        marks = {e["name"]: float(e["ts"]) for e in events
                 if e.get("name") in ("perfbench.trace_start", "perfbench.trace_end")
                 and e.get("cat") in ("user_annotation", "cpu_op")}
        lo, hi = marks["perfbench.trace_start"], marks["perfbench.trace_end"]
        self.trace_window = (lo, hi)
        self.trace_host = (self._trace_t0, t1)
        self.events = [ev for ev in yardstick.device_events(events) if ev[3] > lo and ev[2] < hi]
        self.annotations = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                            for e in events if e.get("cat") == "user_annotation"
                            and str(e.get("name", "")).startswith("perfbench.")
                            and float(e.get("dur", 0) or 0) > 0]

    def tracing(self) -> bool:
        return self._prof is not None

    def close_window(self) -> float:
        """Ends the window (after the caller's last synchronise); returns its
        length in seconds."""
        self.stop_trace()
        end = time.perf_counter()
        self.window = (self.window[0], end)
        return end - self.window[0]

    # -- what the trace says ------------------------------------------------------------
    def busy_s(self) -> float:
        lo, hi = self.trace_window
        return yardstick.busy_us(yardstick.clipped([(a, b) for _, _, a, b in self.events],
                                                   lo, hi)) / 1e6

    def trace_window_s(self) -> float:
        lo, hi = self.trace_window
        return (hi - lo) / 1e6

    def kernel_us(self, *fragments: str) -> tuple:
        """(summed device us, launches) of the kernels whose names hold any
        of ``fragments``."""
        hits = [e for e in self.events if e[0] == "kernel" and any(f in e[1] for f in fragments)]
        return sum(e[3] - e[2] for e in hits), len(hits)

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for _, name, a, b in self.events:
            by_name[name[:120]] = by_name.get(name[:120], 0.0) + (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        lo, hi = self.trace_window
        idle = sorted(yardstick.gaps([(a, b) for _, _, a, b in self.events], lo, hi),
                      key=lambda g: -(g[1] - g[0]))[:10]

        def doing(a, b):
            best, most = "host: no span", 0.0
            for name, s, e in self.annotations:
                o = min(b, e) - max(a, s)
                if o > most and name not in ("perfbench.trace_start", "perfbench.trace_end"):
                    best, most = name[len("perfbench."):], o
            return best
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[doing(a, b), (b - a) / 1e6] for a, b in idle]}


def execute(cell_name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
            device=None, config: Optional[Dict] = None,
            mix: Optional[Dict] = None, control: Optional[str] = None,
            limits: Optional[Dict] = None, forbid: bool = True, out=None,
            err=None) -> int:
    """Runs one cell once and prints its result line; returns the exit
    code.  ``device`` set skips the look for cards (the CPU tests' way in);
    ``config``, ``mix`` and ``limits`` replace the files' (smaller sizes for
    them); ``control`` puts the reference in that lower precision, or with
    that fault, in the program's place for the check, so that the line
    reads not correct (``perfbench/controls.py``), and adds the program's
    own numbers under ``program``; ``forbid=False`` leaves out
    the look for JAX modules, for a test process that loaded them for other
    tests (a test in a fresh process keeps it)."""
    out, err = out or sys.stdout, err or sys.stderr
    bench = load_benchmark()
    cell = find(bench["workloads"], cell_name, "workload")
    config = config or load_config(find(bench["configs"], cell["config"], "configuration"))
    mix = mix or load_mix(cell["traffic"])
    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"perfbench: {cell_name} needs {cell['chips']} CUDA card(s), found {n}",
                  file=err)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    run = Run(cell, config, mix, seed, seconds, trace, device, t_start, control)
    run.limits = limits if limits is not None else load_limits(cell_name)
    driver = importlib.import_module(f"perfbench.drivers.{mix['driver']}")
    res = driver.run(run)
    bad = forbidden_modules() if forbid else []
    if bad:
        print(f"perfbench: modules {bad} are loaded once the window has closed", file=err)
        return 3
    if trace:
        metrics = {}
        for m in cell_metrics(bench, cell_name, "per_layer"):
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["metrics"][m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, cell_name, "end_to_end")}
    checks = res["checks"]
    correct = bool(checks) and all(ok for _, _, _, ok in checks) and res["failed"] == 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line: Dict[str, Any] = {"correct": correct, "attempted": int(res["attempted"]),
                            "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    if trace and run.trace_window is not None:
        dev["busy_s"] = run.busy_s()
        dev["window_s"] = run.trace_window_s()
        line["breakdown"] = run.breakdown()
    if run.control:
        line["program"] = res["program"]
        for name, value in res["program"].items():
            print(f"program {name} {value!r} (the control is checked)", file=err)
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit, _ in checks}
    for note in res.get("notes", []):
        print(note, file=err)
    for name, value, limit, ok in checks:
        print(f"check {name} {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}", file=err)
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return 0


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    return execute(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
