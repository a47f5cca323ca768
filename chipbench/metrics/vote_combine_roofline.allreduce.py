"""The vote's share of its roofline: the protocol's voted rounds in the
window (each over r copies of every node's T words) at the card's
peaks, over the profiled time of the port's vote kernel."""
from chipbench import harness
from chipbench.counts import kernels, peaks, secagg


def read(trace):
    tr = harness.on_card(trace)
    t, count = tr.op_time(kernels.named(kernels.VOTE))
    if not count:
        return None
    p = trace.cell.config["protocol"]
    n, T = p["n_nodes"], trace.cell.config["payload"]["elems_per_node"]
    rounds = secagg.voted_rounds(p["schedule"], n // p["cluster_size"])
    nbytes, int_ops, float_ops = secagg.vote_work(p["redundancy"], n * T)
    bound = rounds * peaks.bound_s(nbytes, int_ops=int_ops,
                                   float_ops=float_ops)
    return 100.0 * tr.iters * bound / t
