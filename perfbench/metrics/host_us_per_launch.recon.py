"""Host time of one ``launch()`` call, in us: the mean of the benchmark's
span around each call in the window, outside the traced part."""
import statistics

from perfbench.readers import window_spans_us


def read(run):
    spans = window_spans_us(run, "launch")
    return statistics.fmean(spans) if spans else None
