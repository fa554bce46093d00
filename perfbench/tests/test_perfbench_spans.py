"""The readers of the program's spans (``perfbench/program_spans.py`` and
the five metrics that read it) on a run whose trace and spans are made
by hand: each returns the value the intervals give, and None where there
is nothing to read (no traced window, no spans, a program without the
trace module, spans of another run)."""
import statistics
import sys

import pytest
import torch

from perfbench import harness, program_spans, yardstick
from repro_torch.core import trace
from repro_torch.core.trace import Span

US = 1e-6
#: the traced window: host seconds 10..11 are trace us 1000..1001000
HOST, WINDOW = (10.0, 11.0), (1000.0, 1001000.0)
NAMES = ("optimizer_ms.train", "replay_us_per_launch.recon", "launch_self_us.recon",
         "idle_in_launch_share.recon", "idle_in_launch_share.train")


def at(t):
    return 1000.0 + (t - HOST[0]) * 1e6


def traced_run(events=()):
    run = harness.Run({"name": "cell"}, {}, {}, 0, 1.0, True, torch.device("cpu"), 0.0)
    run.window = (9.0, 12.0)
    run.trace_host, run.trace_window = HOST, WINDOW
    # each mark's range ends where the host reads its clock
    run.annotations = [("perfbench.trace_start", WINDOW[0] - 5.0, WINDOW[0]),
                       ("perfbench.trace_end", WINDOW[1] - 5.0, WINDOW[1])]
    run.events = list(events)
    return run


def launches():
    """Ten launches of 100 us, 10 ms apart, each with a replay from +20 to
    +50 us; two more on another thread with no replay (self 40 us); and
    spans outside the window (an earlier run's), which no reader takes."""
    out = []
    for k in range(10):
        t = 10.1 + 0.01 * k
        out += [Span("process.replay", t + 20 * US, t + 50 * US, "process.launch", 1),
                Span("process.launch", t, t + 100 * US, None, 1)]
    out += [Span("process.launch", 10.5 + k * 0.01, 10.5 + k * 0.01 + 40 * US, None, 2)
            for k in range(2)]
    out += [Span("process.launch", 9.5, 9.5 + 1e-3, None, 1),
            Span("process.replay", 9.5 + 1e-4, 9.5 + 5e-4, "process.launch", 1),
            Span("process.capture", 10.9, 11.2, "process.launch", 1)]
    return out


def steps():
    """Three training launches with their optimizer's device time (100,
    120 and 110 ms, kept at the launch's start), and one of an earlier
    run."""
    out = [Span("train.launch", 9.0, 9.001, None, 1), Span("train.optimizer", 9.0, 9.2,
                                                             "train.launch", 1)]
    for k, ms in enumerate((100, 120, 110)):
        t = 10.25 + 0.3 * k
        out += [Span("train.replay", t + 300 * US, t + 310 * US, "train.launch", 1),
                Span("train.launch", t, t + 400 * US, None, 1),
                Span("train.optimizer", t, t + ms * 1e-3, "train.launch", 1)]
    return out


def read(name, run):
    return harness.metric_reader(name)(run)


@pytest.fixture
def kept(monkeypatch):
    """The program's spans, as the test sets them."""
    box = []
    monkeypatch.setattr(trace, "spans", lambda: list(box))
    return box


def test_the_host_clock_maps_onto_the_trace_through_the_marks(monkeypatch):
    """Without the probe's offset, along the line through the marks."""
    monkeypatch.setattr(program_spans, "_OFFSETS", {})
    monkeypatch.setattr(program_spans, "clock_offset_us", lambda: None)
    run = traced_run()
    to_us = program_spans.to_trace_us(run)
    assert to_us(10.0) == pytest.approx(1000.0) and to_us(10.5) == pytest.approx(501000.0)
    run.annotations = []                    # no range ends: the window's own edges
    program_spans._OFFSETS.clear()
    assert program_spans.to_trace_us(run)(11.0) == pytest.approx(WINDOW[1])


def test_a_profiled_runs_spans_map_onto_their_own_ranges(monkeypatch):
    """A traced run on the CPU: each span of the program, mapped through
    the probe's offset, lies on its own range in the profiler's trace."""
    seen = {}
    device_events = yardstick.device_events

    def keep(events):
        seen["events"] = events
        return device_events(events)

    monkeypatch.setattr(yardstick, "device_events", keep)
    monkeypatch.setattr(program_spans, "_OFFSETS", {})
    run = harness.Run({"name": "cell"}, {}, {}, 0, 1.0, True, torch.device("cpu"), 0.0)
    run.open_window()
    trace.clear()
    for _ in range(200):
        with trace.span("process.launch"), trace.span("process.replay"):
            torch.ones(64).mul_(2)
    run.stop_trace()
    at = program_spans.to_trace_us(run)
    assert program_spans._OFFSETS[run.trace_host] is not None      # the probe's, not the marks'
    for name in ("process.launch", "process.replay"):
        mine = sorted((at(s.start), at(s.end)) for s in program_spans.named(run, name))
        ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in seen["events"] if e.get("name") == name)
        assert len(mine) == len(ranges) == 200
        off = [max(abs(x[0] - y[0]), abs(x[1] - y[1])) for x, y in zip(mine, ranges)]
        assert statistics.median(off) <= 5.0 and sum(o <= 20.0 for o in off) >= 190, name
    trace.clear()


@pytest.mark.parametrize("offset, took", [(1000.0 - 10e6 + 3.0, True),        # 3 us past the marks
                                          (1000.0 - 10e6 - 3.0, False),       # before their ends
                                          (1000.0 - 10e6 + 300.0, False),     # too far past
                                          (None, False)])                     # no probe session
def test_the_marks_check_the_probes_offset(offset, took, monkeypatch):
    monkeypatch.setattr(program_spans, "_OFFSETS", {})
    monkeypatch.setattr(program_spans, "clock_offset_us", lambda: offset)
    run = traced_run()
    run.annotations = [("perfbench.trace_start", WINDOW[0] - 5.0, WINDOW[0]),
                       ("perfbench.trace_end", WINDOW[1] - 5.0, WINDOW[1] - 20.0)]
    got = program_spans.to_trace_us(run)(10.5)
    assert got == pytest.approx(10.5e6 + offset if took else 1000.0 + 0.5e6 - 10.0)


def test_replay_and_self_time_of_the_recon_launches(kept):
    kept += launches()
    run = traced_run()
    assert read("replay_us_per_launch.recon", run) == pytest.approx(30.0)
    assert read("launch_self_us.recon", run) == pytest.approx((10 * 70.0 + 2 * 40.0) / 12)


def test_self_time_finds_the_innermost_parent_of_nested_spans():
    outer = Span("process.launch", 0.0, 10.0, None, 1)
    inner = Span("process.launch", 2.0, 6.0, "process.launch", 1)
    replay = Span("process.replay", 3.0, 4.0, "process.launch", 1)
    got = program_spans.self_us([outer, inner, replay], [outer, inner])
    assert got == pytest.approx([6e6, 3e6])


def test_the_optimizers_device_time_a_step(kept):
    kept += steps()
    assert read("optimizer_ms.train", traced_run()) == pytest.approx(110.0)


def test_idle_while_the_host_is_inside_a_launch(kept):
    kept += launches() + steps()
    # the device busy all window but for 60 us from 60 us into each even
    # recon launch (40 us of it inside the launch), and 1 ms from the start
    # of each training launch (400 us of it inside)
    idle = [(at(10.1 + 0.01 * k) + 60, at(10.1 + 0.01 * k) + 120) for k in range(0, 10, 2)]
    idle += [(at(10.25 + 0.3 * k), at(10.25 + 0.3 * k) + 1000) for k in range(3)]
    busy, t = [], WINDOW[0]
    for a, b in sorted(idle):
        busy.append(("kernel", "k", t, a))
        t = b
    busy.append(("kernel", "k", t, WINDOW[1]))
    run = traced_run(busy)
    assert read("idle_in_launch_share.recon", run) == pytest.approx(100.0 * 5 * 40 / 1e6)
    assert read("idle_in_launch_share.train", run) == pytest.approx(100.0 * 3 * 400 / 1e6)


def test_overlap_of_interval_sets():
    assert program_spans.overlap_us([(0, 10), (5, 20), (30, 40)], [(8, 35)]) == 17.0
    assert program_spans.overlap_us([], [(0, 1)]) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_gives_none(name, kept, monkeypatch):
    assert read(name, traced_run()) is None                  # no spans
    kept += [s for s in launches() + steps() if s.start < HOST[0]]
    assert read(name, traced_run()) is None                  # only an earlier run's
    kept += launches() + steps()
    untraced = traced_run()
    untraced.trace_host = untraced.trace_window = None
    assert read(name, untraced) is None                      # no traced window
    import repro_torch.core
    monkeypatch.delattr(repro_torch.core, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    assert read(name, traced_run()) is None                  # a program without spans
