"""The MRI cell driven on the CPU at a small size: a sound run is correct,
and the bf16 control and each planted fault of the timed path are not."""
from unittest import mock

import pytest

#: a test size's limit: the program reads about 1e-7 here, the bf16 control
#: about 4e-3 (as at the cell's size)
LIMITS = {"image_rel_err": 1e-4}
MIX = {"stacks": 3}


def test_sound_run_is_correct(cpu_run):
    rc, line, err = cpu_run("cine160.resident", LIMITS, MIX)
    assert rc == 0 and line["correct"] is True
    assert line["checks"]["image_rel_err"]["value"] < 1e-6
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check image_rel_err")
    assert line["metrics"]["recon_frames_per_s"]["value"] > 0
    assert line["attempted"] % 3 == 0 and line["failed"] == 0


def test_bf16_control_is_not_correct(cpu_run):
    rc, line, err = cpu_run("cine160.resident", LIMITS, MIX, control="bf16")
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["image_rel_err"]["value"] > 10 * LIMITS["image_rel_err"]
    assert line["program"]["image_rel_err"] < 1e-6 and list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1].endswith("FAILED")


def _unchanged(self, profile=None):
    """A launch that leaves its output as it was."""


def _half(launch):
    """Every other stack's process never runs."""
    seen = []

    def every_other(self, profile=None):
        if self not in seen:
            seen.append(self)
        if seen.index(self) % 2:
            launch(self, profile)
    return every_other


def _altered(launch):
    def perturbed(self, profile=None):
        launch(self, profile)
        out = self.getApp().getData(self.out_handle).device_view("xdata")
        out[0, 0, 0] += 1e-3 * out.abs().max()
    return perturbed


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_fault_of_the_timed_path_is_not_correct(cpu_run, fault):
    from repro_torch.processes import SimpleMRIRecon
    launch = SimpleMRIRecon.launch
    broken = {"state_unchanged": _unchanged, "half_left_out": _half(launch),
              "answer_altered": _altered(launch)}[fault]
    with mock.patch.object(SimpleMRIRecon, "launch", broken):
        rc, line, _ = cpu_run("cine160.resident", LIMITS, MIX)
    assert rc == 0 and line["correct"] is False


def test_traced_run_reads_its_trace(cpu_run):
    # the trace covers the window's first part, mfu.recon is read after it
    rc, line, _ = cpu_run("cine160.resident", LIMITS, dict(MIX, trace_seconds=0.2), trace=True,
                          seconds=0.6)
    assert rc == 0 and line["correct"] is True
    assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"host_us_per_launch.recon", "mfu.recon"} <= set(line["metrics"])
