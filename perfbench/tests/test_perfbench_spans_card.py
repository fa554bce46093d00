"""The program's spans against the profiler's own trace, on a CUDA card
(marked ``card``; each test skips without one).

A traced run of a cell keeps the program's spans (``repro_torch.core.
trace``) on the host clock and, for each, a profiler range of the same
name in the profiler's trace.  Mapped onto the trace's clock by the
offset that ``perfbench/program_spans.py`` measures in its probe session
after the run, each span lies within 20 us of its own range at both ends,
but for the spans where the host stalled between a range's time stamp
and the span's clock reading (tens to a few hundred us, a few in ten
thousand; at most 0.1 % may).  The median offset of a run's span starts
from their ranges' is under 5 us: the mapping's own error.  That of the
ends is under 20 us: a span reads its end once its range has closed, and
the profiler works on for 11-14 us after stamping the end of a training
step's replay, about 1 us after a recon launch's.  No graph is captured
inside the window.  The run also prints what the mapping does to
``idle_inside_share`` of the launch span (``idle_inside_pct``): through
the probe's offset, and along the line through the harness's two window
marks, which a program span does not meet by an amount that changes from
run to run (``marks_bias_us``).

    python3 -m pytest -q -s -m card perfbench/tests/test_perfbench_spans_card.py
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HOST_SPANS = {"cine160.resident": ("process.launch", "process.replay"),
              "danube.train": ("train.launch", "train.replay")}
#: (seconds, seed) of each cell's traced run, as long as the benchmark's
RUNS = {"cine160.resident": (30, 2**31 + 301), "danube.train": (30, 2**31 + 302)}

CODE = """
import io, json, statistics, sys, time
T = time.perf_counter()
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import harness, program_spans, yardstick
harness.set_cache_dirs()
seen = {{}}
device_events, stop_trace = yardstick.device_events, harness.Run.stop_trace

def keep_events(events):
    seen.setdefault("events", events)
    return device_events(events)

def keep_run(run):
    stop_trace(run)
    if run.trace_window is not None:
        seen.setdefault("run", run)

yardstick.device_events, harness.Run.stop_trace = keep_events, keep_run
out = io.StringIO()
rc = harness.execute({cell!r}, {seed}, {seconds}, True, t_start=T, out=out)
run = seen["run"]
lo, hi = run.trace_window
idle = yardstick.gaps([(a, b) for _, _, a, b in run.events], lo, hi)

def offsets_of(at):
    found = {{}}
    for name in {names!r}:
        mine = sorted((at(s.start), at(s.end)) for s in program_spans.named(run, name))
        ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in seen["events"] if e.get("name") == name
                        and e.get("cat") in ("user_annotation", "cpu_op")
                        and lo <= float(e["ts"]) <= hi)
        pairs = list(zip(mine, ranges))
        off = [max(abs(x[0] - y[0]), abs(x[1] - y[1])) for x, y in pairs]
        found[name] = {{"spans": len(mine), "ranges": len(ranges),
                       "bias_us": [statistics.median(x[i] - y[i] for x, y in pairs)
                                   if pairs else None for i in (0, 1)],
                       "within_20_us": sum(o <= 20.0 for o in off) / max(len(off), 1),
                       "worst_us": max(off, default=None)}}
    return found

def inside_pct(at):
    inside = yardstick.clipped([(at(s.start), at(s.end))
                                for s in program_spans.named(run, {names!r}[0])], lo, hi)
    return 100.0 * program_spans.overlap_us(inside, idle) / (hi - lo)

at = program_spans.to_trace_us(run)
probe = program_spans._OFFSETS[run.trace_host] is not None
offsets, pct = offsets_of(at), {{"probe": inside_pct(at)}}
program_spans._OFFSETS[run.trace_host] = None          # the marks' line
marks = program_spans.to_trace_us(run)
pct["marks"] = inside_pct(marks)
line = json.loads(out.getvalue().strip().splitlines()[-1])
print(json.dumps({{"rc": rc, "probe": probe, "offsets": offsets,
                  "marks_bias_us": {{n: o["bias_us"] for n, o in offsets_of(marks).items()}},
                  "idle_inside_pct": pct, "metrics": line["metrics"],
                  "captures": len(program_spans.named(run, "process.capture"))}}))
"""


def need_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(HOST_SPANS))
def test_program_spans_sit_on_their_trace_ranges(cell):
    need_card()
    seconds, seed = RUNS[cell]
    code = CODE.format(root=str(ROOT), src=str(ROOT / "src"), cell=cell, seed=seed,
                       seconds=seconds, names=HOST_SPANS[cell])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    found = json.loads(proc.stdout.strip().splitlines()[-1])
    print(cell, json.dumps(found))
    assert found["rc"] == 0 and found["captures"] == 0 and found["probe"]
    for name, o in found["offsets"].items():
        assert o["spans"] > 0 and o["spans"] == o["ranges"], (name, o)
        start, end = o["bias_us"]
        assert abs(start) <= 5.0 and abs(end) <= 20.0, (name, o)
        assert o["within_20_us"] >= 0.999, (name, o)
