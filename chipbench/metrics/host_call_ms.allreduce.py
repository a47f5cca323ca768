"""Host milliseconds of one facade call, until it returns (before the
device finishes): the mean of the benchmark's ``bench.call`` spans."""
from statistics import mean


def read(trace):
    spans = trace.span_durations("bench.call")
    return mean(spans) * 1e3 if spans else None
