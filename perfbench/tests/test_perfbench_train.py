"""The training cell driven on the CPU at a small size: a sound run is
correct, and the fp8 control and each planted fault of the timed path are
not."""
from unittest import mock

import pytest
import torch

#: a test size's limits: at this width the program reads about 8e-4 on
#: both, the fp8 control about 1e-2, half the batch about 0.1
LIMITS = {"grad_norm_gap": 4e-3, "change_norm_gap": 4e-3}
MIX = {"batch": 2, "seq": 16}


def test_sound_run_is_correct(cpu_run):
    rc, line, err = cpu_run("danube.train", LIMITS, MIX)
    assert rc == 0 and line["correct"] is True, err
    assert set(line["checks"]) == set(LIMITS)
    assert "loss_rel_gap" in err and "(not compared)" in err
    assert line["metrics"]["train_tokens_per_s"]["value"] > 0


@pytest.mark.parametrize("control", ["fp8", "half_batch"])
def test_control_is_not_correct(cpu_run, control):
    rc, line, _ = cpu_run("danube.train", LIMITS, MIX, control=control)
    assert rc == 0 and line["correct"] is False
    assert any(line["checks"][k]["value"] > LIMITS[k] for k in LIMITS)
    assert all(line["program"][k] <= LIMITS[k] for k in LIMITS)


def _unchanged(self, state, batch):
    """A step that returns its state unchanged."""
    return self._state, {"loss": torch.zeros(())}


def _half(loss_fn):
    def half(self, params, batch, group=None):
        rows = len(batch["tokens"]) // 2
        return loss_fn(self, params, {k: v[:rows] for k, v in batch.items()}, group)
    return half


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_fault_of_the_timed_path_is_not_correct(cpu_run, fault):
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.train.step import TrainProcess
    if fault == "state_unchanged":
        patch = mock.patch.object(TrainProcess, "launch", _unchanged)
    else:
        patch = mock.patch.object(DecoderLM, "loss_fn", _half(DecoderLM.loss_fn))
    with patch:
        rc, line, _ = cpu_run("danube.train", LIMITS, MIX)
    assert rc == 0 and line["correct"] is False
