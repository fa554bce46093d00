"""Host time of the graph replay inside a launch, in us: the mean of the
program's ``process.replay`` spans in the traced window (the call that
hands the captured launch to the device)."""
import statistics

from perfbench import program_spans


def read(run):
    spans = program_spans.named(run, "process.replay")
    return statistics.fmean((s.end - s.start) * 1e6 for s in spans) if spans else None
