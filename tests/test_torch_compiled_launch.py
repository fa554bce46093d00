"""The port's compiled launch (``Process.launch`` on a CUDA app: eager on
the first launch after ``init()``, captured into one CUDA graph on the
second, replayed after), exercised on the CPU through its seam.

The CPU has no CUDA graphs, so each test here makes the launch believe it
runs on the card (``process._graphs_on``) and puts a recorder in the seam
(``process.capture_graph``): the recorder runs the body once at capture,
as a capture runs the Python of a launch, puts back what that run wrote
(a capture executes nothing), and runs the body again at each replay, in
place of the device re-running the captured kernels.  Running
the Python again re-reads the wiring and the host values, which a real
replay does not; so the recorder freezes what a graph bakes in that a
test here can see: the blob of every Data the capture read or wrote, by
address and size.  A replay after such a blob moved fails, as a stale
graph would read or write the old address.  What these tests cover is
the order of eager launches, captures and replays, the rules that drop a
graph, the launch counting and the frozen blobs; a host value baked into
a graph (a launch parameter) is covered only by the rule that drops the
graph when it changes, and the real graphs only on the card
(``chip_smoke.py``).  A kernel launch is seen through the plain version
each wrapper runs on the CPU, patched to count a launch as the CUDA path
does.  The cases run over a single process (``Negate``), a staged and a
fused ``ProcessChain``, and ``SimpleMRIRecon`` (whose launch is its
chain's).  Results are compared exactly: a replay computes what the eager
launch computes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (CLapp, Data, DeviceTraits, DeviceType, KData, Pipeline,
                              ProcessChain, XData, process, registry)
from repro_torch.core.registry import launch_counts, reset_launch_counts
from repro_torch.configs import get_smoke
from repro_torch.kernels import ref
from repro_torch.models import build_model
from repro_torch.processes import Negate, SimpleMRIRecon
from repro_torch.serve import LMServer, SamplingConfig

SHAPE = (2, 3, 8, 6)                      # frames, coils, H, W
PLAIN = {fn: getattr(ref, fn) for fn in ("negate", "ximage_sum", "complex_elementprod")}


class StaleCapture(AssertionError):
    """A replay after a blob its capture read or wrote moved."""


class Recorder:
    """Stands in for ``capture_graph``: logs captures and replays, and
    freezes the blobs a capture saw (``seen``, filled by the fixture's
    hook on ``Data.device_views``).  Its capture runs the body and then
    puts back the bytes of every blob the body saw, so a capture leaves
    the state as a real one does: untouched."""

    def __init__(self, fail_at=None):
        self.events = []
        self.counts_after_capture = None
        self.fail_at = fail_at
        self.seen = None                  # the capture in progress, if any

    def __call__(self, body, device):
        if self.fail_at == "capture":
            raise RuntimeError("capture refused")
        self.events.append("capture")
        self.seen = {}
        try:
            body()
        finally:
            seen, self.seen = self.seen, None
        for data, (_, _, before) in seen.items():   # a capture runs nothing
            data.device_blob.copy_(before)
        frozen = {data: (ptr, n) for data, (ptr, n, _) in seen.items()}
        self.counts_after_capture = launch_counts()

        def replay():
            if self.fail_at == "replay":
                raise RuntimeError("replay failed")
            for data, (ptr, n) in frozen.items():
                blob = data.device_blob
                if blob is None or (blob.data_ptr(), blob.numel()) != (ptr, n):
                    raise StaleCapture(f"a blob of {data!r} moved since the capture")
            self.events.append("replay")
            body()
        return replay


@pytest.fixture
def rec(monkeypatch):
    """Launches compiled as on the card, through a recorder; the plain
    versions count a launch, as their kernels do."""
    recorder = Recorder()
    _seam(monkeypatch, recorder)
    monkeypatch.setattr(process, "_graphs_on", lambda device: True)
    for fn, kname in (("negate", "negate_kernel"), ("ximage_sum", "xImageSum"),
                      ("complex_elementprod", "complexElementProd")):
        def counted(*a, _plain=PLAIN[fn], _name=kname, **kw):
            registry.count_launch(_name)
            return _plain(*a, **kw)
        monkeypatch.setattr(ref, fn, counted)
    reset_launch_counts()
    return recorder


def _seam(monkeypatch, recorder):
    """Put ``recorder`` in the seam, and let it see (and keep the bytes
    of) every blob read or written while it captures."""
    monkeypatch.setattr(process, "capture_graph", recorder)
    views = Data.device_views

    def seen_views(data):
        blob = data.device_blob
        if recorder.seen is not None and blob is not None and data not in recorder.seen:
            recorder.seen[data] = (blob.data_ptr(), blob.numel(), blob.clone())
        return views(data)
    monkeypatch.setattr(Data, "device_views", seen_views)


def _cpu_app():
    return CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))


class Case:
    """One process wired on a CPU app: ``result()`` reads its output,
    ``want(x)`` is what a launch on input ``x`` gives, ``inputs()`` makes a
    fresh input, ``upload(x)`` writes one into the input Data's blob,
    ``rewire()`` points the launch at another Data of the same layout (a
    chain's inner edge, ``SimpleMRIRecon``'s last stage's output),
    ``graph`` is the process that captures (``SimpleMRIRecon``'s chain)
    and ``stages`` are the processes the launch runs inside its own."""

    def __init__(self, kind):
        self.kind = kind
        self.rng = np.random.default_rng(3)
        self.app = app = _cpu_app()
        x = self.inputs()
        if kind == "simple_mri_recon":
            self.h_in = app.addData(KData(dict(zip(("kdata", "sensitivity_maps"), x))))
            f, _, h, w = SHAPE
            self.h_out = app.addData(XData({"xdata": np.zeros((f, h, w), np.complex64)}))
            self.proc = SimpleMRIRecon(app, mode="staged", in_place=False)
            self.proc.in_handle, self.proc.out_handle = self.h_in, self.h_out
            self.proc.init()
            self.kernels = {"complexElementProd": 1, "xImageSum": 1}
            return
        self.h_in = app.addData(XData({"img": x}))
        self.h_out = app.addData(XData({"img": np.zeros_like(x)}))
        if kind == "process":
            self.proc = Negate(app)
            self.proc.in_handle, self.proc.out_handle = self.h_in, self.h_out
            self.kernels = {"negate_kernel": 1}
        else:
            h_mid = app.addData(XData({"img": np.zeros_like(x)}))
            a, b = Negate(app), Negate(app)
            a.in_handle, a.out_handle = self.h_in, h_mid
            b.in_handle, b.out_handle = h_mid, self.h_out
            self.proc = ProcessChain(app, [a, b], mode=kind.removeprefix("chain_"))
            self.kernels = {"negate_kernel": 2}
        self.proc.init()

    @property
    def graph(self):
        return self.proc.chain if self.kind == "simple_mri_recon" else self.proc

    @property
    def stages(self):
        return getattr(self.graph, "stages", [])

    def inputs(self):
        if self.kind == "simple_mri_recon":
            f, c, h, w = SHAPE
            k = self.rng.standard_normal(SHAPE) + 1j * self.rng.standard_normal(SHAPE)
            s = self.rng.standard_normal((c, h, w)) + 1j * self.rng.standard_normal((c, h, w))
            return k.astype(np.complex64), s.astype(np.complex64)
        return self.rng.random((8, 6)).astype(np.float32)

    def want(self, x):
        if self.kind == "simple_mri_recon":
            k, s = (torch.from_numpy(a) for a in x)
            x = PLAIN["complex_elementprod"](torch.fft.ifft2(k, norm="ortho"), s, True)
            return PLAIN["ximage_sum"](x).numpy()
        return 1.0 - x if self.kind == "process" else 1.0 - (1.0 - x)

    def upload(self, x):
        d = self.app.getData(self.h_in)
        for arr, v in zip(d, x if isinstance(x, tuple) else (x,)):
            arr.set_host(v)
        self.app.host2device(self.h_in)

    def result(self):
        return self.app.getData(self.h_out).device_view(0).numpy().copy()

    def rewire(self):
        if self.kind == "simple_mri_recon":
            self.stages[-1].out_handle = self.app.addData(
                self.app.getData(self.h_out).spec_clone())
            return
        h2 = self.app.addData(self.app.getData(self.h_in).spec_clone())
        if self.kind.startswith("chain"):   # the edge between the two stages
            self.stages[0].out_handle = self.stages[1].in_handle = h2
        else:
            self.proc.in_handle = h2


CASES = ["process", "chain_staged", "chain_fused", "simple_mri_recon"]


def _input_of(case):
    d = case.app.getData(case.h_in)
    arrays = tuple(a.host for a in d)
    return arrays if case.kind == "simple_mri_recon" else arrays[0]


@pytest.mark.parametrize("kind", CASES)
def test_first_launch_eager_second_captures_and_replays_later_replay(rec, kind):
    case = Case(kind)
    x = _input_of(case)
    case.proc.launch()
    assert rec.events == [] and (case.graph.captures, case.graph.replays) == (0, 0)
    np.testing.assert_array_equal(case.result(), case.want(x))
    case.proc.launch()
    assert rec.events == ["capture", "replay"]
    assert (case.graph.captures, case.graph.replays) == (1, 1)
    for _ in range(2):
        case.proc.launch()
    assert rec.events == ["capture"] + ["replay"] * 3
    assert (case.graph.captures, case.graph.replays) == (1, 3)
    x2 = case.inputs()                      # a replay reads a new upload
    case.upload(x2)
    case.proc.launch()
    assert rec.events[-1] == "replay" and case.graph.captures == 1
    np.testing.assert_array_equal(case.result(), case.want(x2))


def _drop_by(case, trigger):
    if trigger == "init":
        case.proc.init()
    elif trigger == "launch_parameters":
        case.proc.set_launch_parameters(("changed", 1))
    elif trigger == "rewired_handle":
        case.rewire()
    else:                                   # a blob that moved
        d = case.app.getData(case.h_in)
        d.device_blob = d.device_blob.clone()


@pytest.mark.parametrize("trigger", ["init", "launch_parameters", "rewired_handle",
                                     "moved_blob"])
@pytest.mark.parametrize("kind", CASES)
def test_graph_is_dropped_and_the_next_launch_is_eager(rec, kind, trigger):
    case = Case(kind)
    for _ in range(3):
        case.proc.launch()
    assert (case.graph.captures, case.graph.replays) == (1, 2)
    graph = case.graph
    _drop_by(case, trigger)
    case.proc.launch()                      # eager again
    assert rec.events == ["capture", "replay", "replay"]
    # SimpleMRIRecon's init() builds a new chain, counted from zero
    fresh = case.graph is not graph
    assert fresh == (kind == "simple_mri_recon" and trigger in ("init", "launch_parameters"))
    assert case.graph.replays == (0 if fresh else 2)
    case.proc.launch()                      # captured again
    assert rec.events[-2:] == ["capture", "replay"]
    assert (case.graph.captures, case.graph.replays) == ((1, 1) if fresh else (2, 3))


@pytest.mark.parametrize("kind", CASES)
def test_equal_launch_parameters_keep_the_graph(rec, kind):
    case = Case(kind)
    case.proc.launch()
    case.proc.launch()
    case.proc.set_launch_parameters(case.proc.launch_params)
    case.proc.launch()
    assert rec.events == ["capture", "replay", "replay"]
    assert (case.graph.captures, case.graph.replays) == (1, 2)


def test_new_launch_parameters_of_a_stage_drop_its_chains_graph(rec):
    case = Case("chain_staged")
    for _ in range(2):
        case.proc.launch()
    case.stages[1].set_launch_parameters(("changed", 1))
    case.proc.launch()
    assert rec.events == ["capture", "replay"] and case.stages[1]._initialized
    case.proc.launch()
    assert rec.events[-2:] == ["capture", "replay"]


@pytest.mark.parametrize("kind", CASES)
def test_launch_counts_add_the_captured_tally_once_per_replay(rec, kind):
    case = Case(kind)
    per_launch = case.kernels
    case.proc.launch()
    assert {k: launch_counts()[k] for k in per_launch} == per_launch
    case.proc.launch()
    # the capture itself counted nothing: only the eager launch had
    assert {k: rec.counts_after_capture[k] for k in per_launch} == per_launch
    for _ in range(3):
        case.proc.launch()
    assert {k: launch_counts()[k] for k in per_launch} == {k: 5 * n for k, n in
                                                           per_launch.items()}


@pytest.mark.parametrize("kind", CASES)
def test_the_recorder_fails_a_replay_whose_blob_moved_unseen(monkeypatch, rec, kind):
    """The recorder's teeth: with the launch blind to blob moves (its key
    held fixed), a replay after the input blob moved is stale and fails."""
    monkeypatch.setattr(process.Process, "_graph_key", lambda self: ("fixed",))
    case = Case(kind)
    case.proc.launch()
    case.proc.launch()
    d = case.app.getData(case.h_in)
    d.device_blob = d.device_blob.clone()
    with pytest.raises(StaleCapture):
        case.proc.launch()


@pytest.mark.parametrize("where", ["capture", "replay"])
@pytest.mark.parametrize("kind", CASES)
def test_a_seam_error_reaches_the_caller(monkeypatch, rec, kind, where):
    monkeypatch.setattr(process, "capture_graph", Recorder(fail_at=where))
    case = Case(kind)
    case.proc.launch()
    with pytest.raises(RuntimeError, match=f"{where} (refused|failed)"):
        case.proc.launch()


@pytest.mark.parametrize("kind", ["chain_staged", "chain_fused", "simple_mri_recon"])
def test_a_stage_inside_a_captured_chain_does_not_capture(rec, kind):
    case = Case(kind)
    for _ in range(4):
        case.proc.launch()
    assert case.graph.captures == 1 and rec.events.count("capture") == 1
    assert all((s.captures, s.replays) == (0, 0) for s in case.stages)


def test_a_cpu_app_launches_eagerly(monkeypatch):
    recorder = Recorder()
    _seam(monkeypatch, recorder)
    case = Case("process")
    for _ in range(4):
        case.proc.launch()
    assert recorder.events == [] and (case.graph.captures, case.graph.replays) == (0, 0)


def test_pipeline_run_copies_a_new_input_into_the_same_blob(rec):
    app = _cpu_app()
    pipe = Pipeline(app) | Negate(app).bind()
    rng = np.random.default_rng(5)
    x1, x2 = (rng.random((8, 6)).astype(np.float32) for _ in range(2))
    pipe.run(XData({"img": x1}))
    pipe.run(XData({"img": x1}))
    built = pipe.build()
    blob = app.getData(built.input_handle).device_blob
    ptr = blob.data_ptr()
    out = pipe.run(XData({"img": x2}))
    assert app.getData(built.input_handle).device_blob.data_ptr() == ptr
    assert rec.events == ["capture", "replay", "replay"]
    np.testing.assert_array_equal(out.get_ndarray(0).host, 1.0 - x2)


def test_bound_in_place_pipe_replays_with_no_upload(rec):
    app = _cpu_app()
    x = np.random.default_rng(6).random((8, 6)).astype(np.float32)
    h = app.addData(Data({"img": x}))
    before = app.h2d_bytes[h]
    pipe = Pipeline(app) | Negate(app).bind(infile=h, outfile=h)
    for _ in range(4):
        pipe.run(None, sync=False)
    assert rec.events == ["capture", "replay", "replay", "replay"]
    assert app.h2d_bytes[h] == before


def _served(arch, graphs, monkeypatch=None):
    """An ``LMServer`` at SMOKE size on the CPU, compiled through a
    recorder when ``graphs``: 5 requests through 2 slots, three of them
    one prompt (a repeated length).  Returns the server and its tokens."""
    if graphs:
        recorder = Recorder()
        _seam(monkeypatch, recorder)
        monkeypatch.setattr(process, "_graphs_on", lambda device: True)
    model = build_model(get_smoke(arch))
    params = model.init_params(torch.Generator().manual_seed(0))
    srv = LMServer(model, params, batch=2, max_len=24,
                   sampling=SamplingConfig(max_new_tokens=4), app=_cpu_app())
    rng = np.random.default_rng(8)
    same = rng.integers(0, model.cfg.vocab, 6).tolist()
    for p in (same, rng.integers(0, model.cfg.vocab, 9).tolist(), same, same,
              rng.integers(0, model.cfg.vocab, 4).tolist()):
        srv.submit(p)
    return srv, srv.run()


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-3b", "granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "zamba2-2.7b", "internvl2-2b"])
def test_lmserver_captures_its_decode_step_and_nothing_else(monkeypatch, arch):
    """The decode step is captured once and replayed; every prefill, the
    repeated prompt length's included, and every splice and release stay
    eager; the tokens are the eager server's."""
    eager, want = _served(arch, graphs=False)
    srv, got = _served(arch, graphs=True, monkeypatch=monkeypatch)
    assert got == want and got[0][0] == got[2][0] == got[3][0]
    step = srv.decode_pipe.build().executor
    assert (step.captures, step.replays) == (1, srv.steps - 1)
    others = ([p.build().executor for p in srv._prefill_pipes.values()]
              + list(srv._splice.values()) + list(srv._release.values()))
    assert len(srv._prefill_pipes) == 3 and len(others) == 3 + 2 + 2
    assert all((p.captures, p.replays) == (0, 0) for p in others)
