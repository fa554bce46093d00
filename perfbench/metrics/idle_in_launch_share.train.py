"""The traced window's share, in %, in which the device runs nothing while
the host is inside a training launch (the program's ``train.launch``
spans on the trace's clock: the checks, the batch's copy into the
captured inputs and the replay call)."""
from perfbench import program_spans


def read(run):
    return program_spans.idle_inside_share(run, "train.launch")
