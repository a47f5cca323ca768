"""Secure function layer: non-additive aggregations over the additive
engine.

Counterpart of ``repro/funcs``.  Every richer function compiles into a
static sequence of engine allreduces over derived {0, 1} payloads, so
the voted hops, the digest transport and the three ring kernels are
reused as they are:

  * **histogram**: each node ships a one-hot row over ``bins``; the
    engine's exact sum is the frequency table (one allreduce);
  * **quantile / min / max / median**: bisection over a
    :class:`ValueDomain` grid, one allreduce of a 1-element threshold
    count a round, ``ceil(log2(steps))`` rounds pinned by
    :class:`~repro_torch.core.plan.FuncPlan`;
  * **top-k**: the quantile bisection for the k-th-largest threshold,
    then one full-domain thresholded histogram reads off the values.

Every aggregate is a node count, so the fixed-point headroom rule makes
it exact and the engine's faulty == honest guarantee carries over; the
wire bytes of each round come from the same ``hop_wire_words`` account
(``FuncPlan.wire_bytes`` == the executed bytes summed over the rounds).

Entry points: the facade verbs (``SecureAggregator.histogram`` /
``quantile`` / ``minimum`` / ``maximum`` / ``median`` / ``topk``),
multi-round service sessions (``open_session(fn=...)`` ->
:class:`FuncSession`), or a raw :class:`FuncRun` fed by any transport.
"""
from repro_torch.core.plan import FuncPlan, compile_func_plan
from repro_torch.funcs.domain import ValueDomain, bin_edges, bin_index
from repro_torch.funcs.run import (FuncRun, one_hot_payload,
                                   threshold_payload, thresholded_one_hot)
from repro_torch.funcs.session import FuncSession

__all__ = [
    "FuncPlan", "FuncRun", "FuncSession", "ValueDomain", "bin_edges",
    "bin_index", "compile_func_plan", "one_hot_payload",
    "threshold_payload", "thresholded_one_hot",
]
