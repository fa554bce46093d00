"""The device time of the training step's optimizer, in ms: the mean of
the program's ``train.optimizer`` spans in the traced window (the time
between the two events the step's graph records around the clip's global
norm, AdamW and the parameter cast, at every replay)."""
import statistics

from perfbench import program_spans


def read(run):
    spans = program_spans.named(run, "train.optimizer")
    return statistics.fmean((s.end - s.start) * 1e3 for s in spans) if spans else None
