"""A whole launch against its roofline, in %: the larger of its bytes
(k-space and maps read, image written) over the memory rate and its
FFT's operations over the fp32 rate, over the time a launch took in the
window's part after the trace (host clock; the profiler slows the host
while it traces)."""
from perfbench import yardstick


def read(run):
    n, seconds = run.counters.get("untraced_launches"), run.counters.get("untraced_s")
    if not n or not seconds:
        return None
    shape = tuple(run.config[k] for k in ("frames", "coils", "height", "width"))
    return 100.0 * yardstick.mri_launch_bound_s(*shape) * n / seconds
