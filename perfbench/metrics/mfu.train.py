"""Model flops utilisation of the training step, in %: 6 N tokens a step
over the traced window's time a step, at the bf16 tensor rate."""
from perfbench import yardstick


def read(run):
    steps = run.counters.get("traced_steps")
    if not steps or run.trace_window is None:
        return None
    tokens = int(run.mix["batch"]) * int(run.mix["seq"])
    flops = yardstick.train_step_flops(yardstick.decoder_params(run.config), tokens)
    return 100.0 * flops * steps / run.trace_window_s() / yardstick.H100["bf16_tensor"]
