"""Helpers of the per-layer metric readers (``perfbench/metrics/``)."""
from __future__ import annotations

from typing import List, Optional


def idle_share(run) -> Optional[float]:
    """The traced window's share, in %, in which no kernel, copy or memset
    ran on the device."""
    if run.trace_window is None or not run.events:
        return None
    return 100.0 * (1.0 - run.busy_s() / run.trace_window_s())


def window_spans_us(run, name: str) -> List[float]:
    """The window's ``name`` spans, in us, outside the traced part when
    there are such (the profiler slows the host)."""
    lo, hi = run.window
    spans = run.spans_in(name, lo, hi)
    if run.trace_host is not None:
        a, b = run.trace_host
        outside = [(s, e) for s, e in spans if e <= a or s >= b]
        spans = outside or spans
    return [(e - s) * 1e6 for s, e in spans]
