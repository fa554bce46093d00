"""The port's spans (``repro_torch.core.trace``) on the CPU.

With no profiler active a span is one flag test: the launch opens no
profiler range, reads no clock and keeps nothing.  Under a CPU
``torch.profiler`` the compiled launch (through the capture seam's
recorder of ``test_torch_compiled_launch.py``) keeps ``process.launch``
with its ``process.capture`` and ``process.replay`` children, the
profiler's trace holds a range of each, threads keep their own parents,
and a ``TrainProcess`` keeps ``train.launch``, ``train.replay`` and the
device span ``train.optimizer`` inside its launch.  The bounded buffer
counts what it drops, as does a device span recorded again before it was
read.  The registry's graph hits and misses (``compile_cache_stats``)
add up under many threads.
"""
import collections
import contextlib
import sys
import threading
import types

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import compile_cache_stats, process, registry, trace
from repro_torch.core.arena import tree_flatten
from repro_torch.core.registry import launch_counts
from repro_torch.data.pipeline import StreamConfig, TokenStream
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, Schedule
from repro_torch.train import TrainConfig, TrainProcess, make_train_state

from test_torch_compiled_launch import Case, rec  # noqa: F401  (the fixture)


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def spans():
    """An empty span buffer, emptied again afterwards."""
    trace.clear()
    yield trace
    trace.clear()


def _train_setup(device="cpu"):
    cfg = get_smoke("h2o-danube-1.8b")
    model = build_model(cfg)
    stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=16, batch=2))
    tcfg = TrainConfig(opt=AdamWConfig(schedule=Schedule(kind="constant", base_lr=1e-3,
                                                         warmup_steps=0)))
    return model, tcfg, stream, make_train_state(model, 1, device=device)


@pytest.fixture
def unopened(spans, monkeypatch):
    """No profiler: the ranges the spans open (none, the test checks), and
    a clock that fails if a span reads it."""
    assert not trace.active()
    opened = []
    monkeypatch.setattr(trace, "_range", lambda name: opened.append(name))

    def no_clock():
        raise AssertionError("a span read the clock")
    monkeypatch.setattr(trace, "_clock", no_clock)
    return opened


def test_without_a_profiler_a_span_is_one_flag_test(unopened):
    assert trace.span("process.launch") is trace.span("train.launch") is trace._OFF
    with trace.span("process.launch"):
        pass
    assert unopened == [] and trace.spans() == []


def test_without_a_profiler_a_launch_keeps_nothing(rec, unopened):
    case = Case("simple_mri_recon")
    for _ in range(3):                      # eager, captured, replayed
        case.proc.launch()
    assert rec.events == ["capture", "replay", "replay"]
    assert unopened == [] and trace.spans() == [] and trace.dropped() == 0


def test_without_a_profiler_a_train_launch_keeps_nothing(unopened):
    model, tcfg, stream, state = _train_setup()
    proc = TrainProcess(model, tcfg).init(state, stream.batch_at(0))
    proc.launch(state, stream.batch_at(0))
    assert unopened == [] and trace.spans() == [] and trace.dropped() == 0


def test_launch_spans_nest_under_a_cpu_profiler(rec, spans):
    case = Case("simple_mri_recon")
    with _profiled() as prof:
        for _ in range(4):                  # eager, captured, replayed twice
            case.proc.launch()
    kept = trace.spans()
    assert [(s.name, s.parent) for s in kept] == [
        ("process.launch", None),
        ("process.capture", "process.launch"), ("process.replay", "process.launch"),
        ("process.launch", None),
        ("process.replay", "process.launch"), ("process.launch", None),
        ("process.replay", "process.launch"), ("process.launch", None)]
    launches = [s for s in kept if s.name == "process.launch"]
    for child in (s for s in kept if s.parent is not None):
        assert any(p.start <= child.start and child.end <= p.end for p in launches)
    assert len({s.thread for s in kept}) == 1
    names = collections.Counter(e.name for e in prof.events())
    assert [names[f"process.{n}"] for n in ("launch", "replay", "capture")] == [4, 3, 1]
    with _profiled():
        pass
    case.proc.launch()                       # no profiler: nothing more
    assert len(trace.spans()) == len(kept)


def test_threads_keep_their_own_parents(rec, spans):
    cases = [Case("process") for _ in range(4)]
    for case in cases:                      # eager and captured, one thread
        case.proc.launch()
        case.proc.launch()
    before = len(rec.events)
    # all four alive at once (a finished thread's ident can be reused)
    together = threading.Barrier(len(cases), timeout=60)

    def launch(case):
        together.wait()
        for _ in range(20):
            case.proc.launch()
        together.wait()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            threads = [threading.Thread(target=launch, args=(c,)) for c in cases]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert rec.events[before:] == ["replay"] * 80
    kept = trace.spans()
    assert collections.Counter(s.name for s in kept) == {"process.launch": 80,
                                                         "process.replay": 80}
    by_thread = collections.defaultdict(list)
    for s in kept:
        by_thread[s.thread].append(s)
    assert len(by_thread) == 4
    for row in by_thread.values():          # each replay inside its own thread's launch
        launches = [s for s in row if s.name == "process.launch"]
        for r in (s for s in row if s.name == "process.replay"):
            assert r.parent == "process.launch"
            assert any(p.start <= r.start and r.end <= p.end for p in launches)


def test_the_buffer_keeps_the_newest_and_counts_what_it_drops(spans, monkeypatch):
    monkeypatch.setattr(trace, "LIMIT", 3)
    monkeypatch.setattr(trace, "_BUFFER", collections.deque(maxlen=3))
    with _profiled():
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    assert [s.name for s in trace.spans()] == ["s2", "s3", "s4"] and trace.dropped() == 2
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


class _Event:
    """A timing event whose completion the test sets."""

    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_a_device_span_is_read_once_done_and_dropped_when_recorded_again(spans):
    ready = _Event(0.0, done=False)
    with _profiled():
        assert trace.device_span("d", _Event(1.0), _Event(1.25), ready) is None  # no open span
        with trace.span("outer"):
            first = trace.device_span("d", _Event(1.0), _Event(1.25), ready)
            second = trace.device_span("d", _Event(2.0), _Event(2.5), ready)
        outer = trace.spans()[-1]
    assert [s.name for s in trace.spans()] == ["outer"]       # not done: still pending
    trace.settle(first, last=True)                            # recorded again: dropped
    assert trace.dropped() == 1
    ready.done = True
    kept = trace.spans()                                      # read without waiting
    assert [(s.name, s.parent) for s in kept] == [("outer", None), ("d", "outer")]
    assert kept[1].start == outer.start and kept[1].end - kept[1].start == pytest.approx(0.5)
    trace.settle(second, last=True)                           # already read: nothing
    assert len(trace.spans()) == 2 and trace.dropped() == 1


def test_train_process_keeps_the_optimizer_span_on_the_cpu(spans):
    model, tcfg, stream, state = _train_setup()
    proc = TrainProcess(model, tcfg).init(state, stream.batch_at(0))
    with _profiled():
        for i in range(2):
            proc.launch(state, stream.batch_at(i))
    proc.launch(state, stream.batch_at(2))   # no profiler: nothing kept
    kept = trace.spans()
    assert [(s.name, s.parent) for s in kept] == [
        ("train.launch", None), ("train.optimizer", "train.launch")] * 2
    for launch, opt in zip(kept[::2], kept[1::2]):
        assert opt.start == launch.start and 0 < opt.end - opt.start <= launch.end - launch.start
    assert trace.dropped() == 0


class _Streams:
    class Stream:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass


@pytest.fixture
def captured(monkeypatch):
    """TrainProcess as on the card (the capture runs the body and puts back
    the state; each replay runs the body again)."""
    rec = types.SimpleNamespace(events=[], state=None)

    def capture(body, device):
        rec.events.append("capture")
        before = [t.clone() for _, t in tree_flatten(rec.state)]
        body()
        for (_, t), b in zip(tree_flatten(rec.state), before):
            t.copy_(b)

        def replay():
            rec.events.append("replay")
            body()
        return replay

    monkeypatch.setattr(process, "_graphs_on", lambda device: True)
    monkeypatch.setattr(process, "capture_graph", capture)
    monkeypatch.setattr(torch.cuda, "Stream", _Streams.Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Streams.Stream())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return rec


def test_captured_train_process_reads_each_replays_pair(spans, captured):
    model, tcfg, stream, state = _train_setup()
    captured.state = state
    proc = TrainProcess(model, tcfg).init(state, stream.batch_at(0))
    proc.launch(state, stream.batch_at(0))  # no profiler: the pair recorded, not kept
    with _profiled():
        for i in range(1, 4):
            proc.launch(state, stream.batch_at(i))
    assert captured.events == ["capture"] + ["replay"] * 4
    kept = trace.spans()                     # the last pair is read here
    assert [(s.name, s.parent) for s in kept] == [
        ("train.replay", "train.launch"), ("train.launch", None),
        ("train.optimizer", "train.launch")] * 3
    launches = [s for s in kept if s.name == "train.launch"]
    for launch, opt in zip(launches, (s for s in kept if s.name == "train.optimizer")):
        assert opt.start == launch.start and opt.end > opt.start
    assert trace.dropped() == 0


def test_graph_hits_and_launches_add_up_under_threads(monkeypatch):
    monkeypatch.setitem(registry._GLOBAL, "trace_test_kernel",
                        registry.KernelEntry(name="trace_test_kernel", fn=lambda: None))
    h0, m0 = compile_cache_stats()
    n0 = launch_counts()["trace_test_kernel"]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(300):
            registry.add_launches({"trace_test_kernel": 2}, hit=1)
            registry.count_capture()
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    h1, m1 = compile_cache_stats()
    assert (h1 - h0, m1 - m0) == (4800, 4800) and registry.graph_counts() == (h1, m1)
    assert launch_counts()["trace_test_kernel"] - n0 == 9600
