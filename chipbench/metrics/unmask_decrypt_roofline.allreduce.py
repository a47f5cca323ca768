"""The unmask's share of its roofline: the protocol's unmask work in the
window (every node's row unmasked and dequantized, global masking's n
pads an element) at the card's peaks, over the profiled time of the
port's unmask kernel."""
from chipbench import harness
from chipbench.counts import kernels, peaks, secagg


def read(trace):
    tr = harness.on_card(trace)
    t, count = tr.op_time(kernels.named(kernels.UNMASK))
    if not count:
        return None
    cfg = tr.cell.config
    n = cfg["protocol"]["n_nodes"]
    T = cfg["payload"]["elems_per_node"]
    nbytes, int_ops, float_ops = secagg.unmask_work(n, T, n)
    bound = peaks.bound_s(nbytes, int_ops=int_ops, float_ops=float_ops)
    return 100.0 * tr.iters * bound / t
