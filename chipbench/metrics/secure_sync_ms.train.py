"""Host milliseconds a step in the program's ``secure_sync`` span (the
gradient sync's quantize, mask, unmask and dequantize over its
chunks)."""
from statistics import mean


def read(trace):
    spans = trace.span_durations("secure_sync")
    return mean(spans) * 1e3 if spans else None
