"""The flash backward (its three flash_bwd_* kernels) against its compute
bound, in %: 10 D flops a visible pair and query head at the bf16 tensor
rate, over their summed device time in the trace."""
from perfbench import yardstick


def read(run):
    t_us, _ = run.kernel_us("flash_bwd_")
    _, layers = run.kernel_us("flash_bwd_mma_dq", "flash_bwd_dq")
    if not layers or not t_us:
        return None
    a = run.config
    flops = yardstick.flash_bwd_flops(int(run.mix["batch"]), a["n_heads"], int(run.mix["seq"]),
                                      a["d_head"], a.get("window"))
    return 100.0 * layers * flops / yardstick.H100["bf16_tensor"] / (t_us / 1e6)
