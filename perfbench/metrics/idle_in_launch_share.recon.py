"""The traced window's share, in %, in which the device runs nothing while
the host is inside a launch (the program's ``process.launch`` spans on
the trace's clock): the device waiting on the launch path itself.

How far the spans land from their own ranges moves the share: on an
H100's host, through the probe's clock offset (``program_spans``), a
run's span starts sit within 0.3 us of their ranges', about a hundredth
of a point of the share; along the line through the harness's two window
marks they sat 6.6-15.8 us early and the share read 0.00-0.45 points
high."""
from perfbench import program_spans


def read(run):
    return program_spans.idle_inside_share(run, "process.launch")
