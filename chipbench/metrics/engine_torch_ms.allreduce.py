"""Device milliseconds a call in work that is not the port's own kernels:
the engine's torch gathers, selects, casts and digests, and copies."""
from chipbench import harness
from chipbench.counts import kernels


def read(trace):
    tr = harness.on_card(trace)
    if not tr.iters or not tr.ops:
        return None
    port = kernels.named(kernels.PORT)
    t, _ = tr.op_time(lambda n: not port(n),
                      kinds=("kernel", "memcpy", "memset"))
    return t / tr.iters * 1e3
