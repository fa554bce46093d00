"""Host time of a launch outside its replay and capture, in us: the mean
of the program's ``process.launch`` spans in the traced window, each less
its child spans (the graph's key, the donation check, the counters and
the written marks)."""
import statistics

from perfbench import program_spans


def read(run):
    spans = program_spans.window_spans(run) or []
    launches = [s for s in spans if s.name == "process.launch"]
    if not launches:
        return None
    return statistics.fmean(program_spans.self_us(spans, launches))
