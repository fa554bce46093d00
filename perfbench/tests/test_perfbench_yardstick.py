"""The frozen arithmetic, the trace reduction, the traffic generator and
the per-layer readers."""
import json

import numpy as np
import pytest

from perfbench import mixes, yardstick
from perfbench.harness import ROOT, Run, metric_reader

DANUBE = json.loads((ROOT / "perfbench/configs/h2o-danube-1.8b.json").read_text())
CINE = (16, 8, 160, 160)


def test_mri_launch_bytes_and_bound():
    assert yardstick.mri_launch_bytes(*CINE) == 26_214_400 + 1_638_400 + 3_276_800
    assert yardstick.mri_launch_bytes(*CINE) / 1e6 == pytest.approx(31.13, abs=0.005)
    assert yardstick.mri_launch_bound_s(*CINE) * 1e6 == pytest.approx(9.29, abs=0.005)
    assert yardstick.mri_fft_flops(*CINE) / 1e9 == pytest.approx(0.266, abs=0.0005)


def test_decoder_counts():
    n = yardstick.decoder_params(DANUBE)
    assert n == DANUBE["n_params"] == 1_831_201_280
    assert yardstick.train_step_flops(n, 4 * 2048) == 6.0 * n * 8192


def test_flash_backward_count():
    flops = yardstick.flash_bwd_flops(4, 32, 2048, 80, 4096)
    assert flops == 10 * 4 * 32 * 80 * (2048 * 2049 // 2)
    assert flops / yardstick.H100["bf16_tensor"] * 1e3 == pytest.approx(0.21724, abs=5e-6)
    assert yardstick.causal_pairs(4, 4, window=2) == 1 + 2 + 2 + 2


def test_trace_reduction():
    events = [{"cat": "kernel", "name": "a", "ts": 0, "dur": 10},
              {"cat": "gpu_memcpy", "name": "m", "ts": 5, "dur": 10},
              {"cat": "cpu_op", "name": "host", "ts": 0, "dur": 100},
              {"cat": "kernel", "name": "b", "ts": 30, "dur": 0},
              {"cat": "kernel", "name": "c", "ts": 40, "dur": 10}]
    dev = yardstick.device_events(events)
    assert [e[1] for e in dev] == ["a", "m", "c"]
    spans = [(a, b) for _, _, a, b in dev]
    assert yardstick.merged(spans) == [[0, 15], [40, 50]]
    assert yardstick.busy_us(spans) == 25
    assert yardstick.gaps(spans, 0, 60) == [(15, 40), (50, 60)]
    assert yardstick.clipped(spans, 8, 45) == [[8, 10], [8, 15], [40, 45]]


@pytest.mark.parametrize("name", ["resident", "train"])
def test_mix_is_found_by_name_with_its_driver(name):
    mix = mixes.load_mix(name)
    assert (ROOT / "perfbench/drivers" / f"{mix['driver']}.py").is_file()
    with pytest.raises(FileNotFoundError):
        mixes.load_mix(name + "-missing")


def test_batches_are_the_seeds():
    b0, b1 = mixes.train_batch(9, 0, 4, 16, 50), mixes.train_batch(9, 1, 4, 16, 50)
    assert all(np.array_equal(b0[k], mixes.train_batch(9, 0, 4, 16, 50)[k]) for k in b0)
    assert not np.array_equal(b0["tokens"], mixes.train_batch(2**31 + 9, 0, 4, 16, 50)["tokens"])
    assert b0["tokens"].shape == (4, 16) and b0["tokens"].dtype == np.int32
    assert b0["tokens"].max() < 50 and b0["tokens"].min() >= 0
    assert np.array_equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    assert len({tuple(r) for r in np.concatenate([b0["tokens"], b1["tokens"]])}) == 8


def _run(events, counters=None, config=None, mix=None):
    run = Run({"name": "x"}, config or {}, mix or {}, 1, 1.0, True, None, 0.0)
    run.events = events
    run.trace_window = (0.0, 1e6)
    run.counters = counters or {}
    return run


def test_readers_read_the_trace_and_return_nothing_on_no_data():
    cfg = dict(zip(("frames", "coils", "height", "width"), CINE))
    bound_us = yardstick.mri_launch_bound_s(*CINE) * 1e6
    events = [("kernel", "void regular_fft<160u>", i * 100.0, i * 100.0 + 50) for i in range(10)]
    events += [("kernel", "cprod_kernel(float2)", i * 100.0 + 50, i * 100.0 + 90)
               for i in range(10)]
    run = _run(events, {"traced_launches": 10, "untraced_launches": 90, "untraced_s": 0.01}, cfg)
    # 90 us of device time a launch, 90 launches in 10 ms after the trace
    assert metric_reader("idle_share.recon")(run) == pytest.approx(100 * (1 - 90e-6 * 90 / 0.01))
    assert metric_reader("idle_share.train")(run) == pytest.approx(100 * (1 - 900 / 1e6))
    assert metric_reader("mfu.recon")(run) == pytest.approx(100 * bound_us * 90 / 1e4)
    empty = _run([], {}, cfg)
    for name in ("idle_share.recon", "mfu.recon", "flash_bwd_roofline", "mfu.train"):
        assert metric_reader(name)(empty) is None
    empty.window = (0.0, 1.0)
    assert metric_reader("host_us_per_launch.recon")(empty) is None


def test_flash_backward_reader():
    mix = {"batch": 4, "seq": 2048}
    events = [("kernel", "flash_bwd_delta_kernel<80>", 0.0, 100.0),
              ("kernel", "flash_bwd_mma_dkdv_kernel<80>", 100.0, 900.0),
              ("kernel", "flash_bwd_mma_dq_kernel<80>", 900.0, 1300.0)]
    run = _run(events, {}, DANUBE, mix)
    want = 100 * yardstick.flash_bwd_flops(4, 32, 2048, 80, 4096) / yardstick.H100[
        "bf16_tensor"] / 1.3e-3
    assert metric_reader("flash_bwd_roofline")(run) == pytest.approx(want)
