"""Device kernels launched a call, from the profiler."""
from chipbench import harness


def read(trace):
    tr = harness.on_card(trace)
    if not tr.iters:
        return None
    _, count = tr.op_time(lambda n: True)
    return count / tr.iters if count else None
