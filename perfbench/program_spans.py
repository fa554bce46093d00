"""The program's own spans (``repro_torch.core.trace``) for the per-layer
metric readers: those of the traced window, placed on the trace's clock.

The program keeps a span while a profiler runs, on the host clock
(``time.perf_counter`` seconds), and opens a profiler range of its name.
The profiler stamps its trace on the wall clock less a fixed base, which
within one process stays a fixed number of microseconds off
``perf_counter``'s (within about 1 us over a minute on an H100's host).
So a span maps onto the trace's microseconds by that offset, measured
after the run in a probe session of the profiler: the median, over
``PROBES`` ranges of the spans' own kind, of a range's start stamp less
the clock reading right after it opens, which is how a span reads its
start.  The harness's window marks give the check: it reads the host
clock right after each mark's range has closed (``run.trace_host``), so
each reading maps onto the trace after its mark's end, and less than
``MARK_US`` after (the host's return from the range: a few us, tens at
times, on an H100's host).  Where the probe cannot run (a profiler is already active)
or misses that check, the line through the two marks' pairs (the range's
end, the reading after it) maps the spans instead: 6.6-28.4 us early on
an H100's host, by an amount that changes from run to run.  A span is the window's when it
lies within ``run.trace_host``, so the spans of earlier runs in the same
process do not mix in.

A program without the trace module, or a run with no traced window,
gives None: the readers then leave their metric out.
"""
from __future__ import annotations

import bisect
import json
import statistics
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from perfbench import yardstick


def window_spans(run) -> Optional[list]:
    """Every program span of the traced window, or None where the program
    keeps no spans or the run traced nothing."""
    if run.trace_host is None or run.trace_window is None:
        return None
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    lo, hi = run.trace_host
    return [s for s in trace.spans() if lo <= s.start and s.end <= hi]


def named(run, name: str) -> list:
    """The window's spans called ``name`` (empty where there are none)."""
    return [s for s in window_spans(run) or () if s.name == name]


WINDOW_MARKS = ("perfbench.trace_start", "perfbench.trace_end")
#: the probe session's ranges
PROBES = 256
#: the most a mark's clock reading may map past its range's end
MARK_US = 100.0
#: per traced window: the probe's offset, or None where it was refused
_OFFSETS: Dict[tuple, Optional[float]] = {}


def to_trace_us(run) -> Callable[[float], float]:
    """Host ``perf_counter`` seconds to the trace's microseconds."""
    ends: Dict[str, float] = {n: e for n, _, e in run.annotations if n in WINDOW_MARKS}
    a = ends.get("perfbench.trace_start", run.trace_window[0])
    b = ends.get("perfbench.trace_end", run.trace_window[1])
    h0, h1 = run.trace_host
    if run.trace_host not in _OFFSETS:
        off = clock_offset_us()
        fits = off is not None and all(0.0 <= h * 1e6 + off - e <= MARK_US
                                       for h, e in ((h0, a), (h1, b)))
        _OFFSETS[run.trace_host] = off if fits else None
    off = _OFFSETS[run.trace_host]
    if off is not None:
        return lambda t: t * 1e6 + off
    scale = (b - a) / ((h1 - h0) * 1e6)
    return lambda t: a + (t - h0) * 1e6 * scale


def clock_offset_us() -> Optional[float]:
    """The profiler trace's microseconds less ``perf_counter``'s at one
    instant, from a probe session of the profiler in this process; None
    where no session can start or its trace cannot be read."""
    import tempfile

    import torch
    from repro_torch.core import trace

    reads = []
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(PROBES):
                r = trace._range("perfbench.clock_probe")
                r.__enter__()
                reads.append(time.perf_counter())
                r.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "probe.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
    except (RuntimeError, OSError, ValueError, KeyError):
        return None
    stamps = sorted(float(e["ts"]) for e in events if e.get("name") == "perfbench.clock_probe")
    if len(stamps) != len(reads):
        return None
    return statistics.median(s - t * 1e6 for s, t in zip(stamps, reads))


def self_us(spans: Sequence, parents: Sequence) -> List[float]:
    """Each of ``parents``' duration less what its children among
    ``spans`` (of the same thread, inside it, naming it as parent) take,
    in us."""
    by_thread: Dict[int, list] = {}
    for p in sorted(parents, key=lambda s: s.start):
        by_thread.setdefault(p.thread, []).append(p)
    starts = {t: [p.start for p in row] for t, row in by_thread.items()}
    left = {id(p): p.end - p.start for p in parents}
    for c in spans:
        row = by_thread.get(c.thread)
        if not row:
            continue
        i = bisect.bisect_right(starts[c.thread], c.start) - 1
        while i >= 0 and (row[i] is c or row[i].end < c.end):   # the innermost around it
            i -= 1
        if i >= 0 and c.parent == row[i].name:
            left[id(row[i])] -= c.end - c.start
    return [left[id(p)] * 1e6 for p in parents]


def overlap_us(xs: Sequence[Sequence[float]], ys: Sequence[Sequence[float]]) -> float:
    """The length both of two sets of (start, end) intervals cover."""
    a, b = yardstick.merged(xs), yardstick.merged(ys)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_share(run, name: str) -> Optional[float]:
    """The traced window's share, in %, in which no device activity runs
    while the host is inside a ``name`` span."""
    spans = named(run, name)
    if not spans:
        return None
    lo, hi = run.trace_window
    at = to_trace_us(run)
    inside = yardstick.clipped([(at(s.start), at(s.end)) for s in spans], lo, hi)
    idle = yardstick.gaps([(a, b) for _, _, a, b in run.events], lo, hi)
    return 100.0 * overlap_us(inside, idle) / (hi - lo)
