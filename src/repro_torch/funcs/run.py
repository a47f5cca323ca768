"""The secure-function state machine: derived payloads in, revealed
counts out.

Counterpart of ``repro/funcs/run.py``.  :class:`FuncRun` drives one
compiled :class:`~repro_torch.core.plan.FuncPlan` against any executor
of the additive engine: the facade verbs, the service's batched
executor, or a raw ``sim_batch`` / ``MeshTransport`` call.  The run owns
only the public protocol state (the bisection interval, the revealed
counts); the caller owns transport and scheduling:

    run = FuncRun(fplan, values)
    while not run.done:
        payload = run.next_payload()          # (n, T) {0,1} float32 numpy
        revealed = <any engine allreduce>(payload)
        run.feed(revealed)                    # a tensor on any device
    run.result

Every payload row is a {0, 1} indicator, so the engine's exact sum
reveals a node count and ``np.rint`` recovers the integer (the
``clip >= 1.0`` precondition of ``compile_func_plan`` leaves fixed-point
headroom for counts up to n_nodes).  The reveal between rounds is the
protocol: :meth:`feed` reads the round's counts to the host once.  The
round count is static: once the interval pins early, the remaining
rounds are no-op halvings, so every run of a plan ships the same payload
shapes in the same order.

Absent nodes (``present[i] == False``) ship all-zero rows and are
rank-invisible; ranks are computed over the present population.  With
no node present every count is 0, the bisection walks to the top of the
domain, and a quantile reveals ``hi`` (top-k an empty list).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.plan import FuncPlan
from repro_torch.core.schedules import _require
from repro_torch.funcs.domain import ValueDomain, bin_index

__all__ = ["FuncRun", "one_hot_payload", "threshold_payload",
           "thresholded_one_hot", "quantile_rank"]


# ---------------------------------------------------------------------------
# payload builders (pure numpy, shared with tests and the smoke run)
# ---------------------------------------------------------------------------

def one_hot_payload(values, bins: int, lo: float, hi: float,
                    present=None) -> np.ndarray:
    """(n, bins) float32 one-hot rows under ``np.histogram`` binning;
    absent rows are all-zero."""
    idx = bin_index(values, bins, lo, hi)
    n = idx.shape[0]
    out = np.zeros((n, bins), dtype=np.float32)
    rows = np.arange(n) if present is None else np.flatnonzero(present)
    out[rows, idx[rows]] = 1.0
    return out


def threshold_payload(idx, mid: int, present=None) -> np.ndarray:
    """(n, 1) float32 indicator ``grid_index <= mid`` (a bisection
    round's count payload); absent rows are zero."""
    idx = np.asarray(idx, dtype=np.int64)
    flag = (idx <= mid).astype(np.float32)
    if present is not None:
        flag = flag * np.asarray(present, dtype=np.float32)
    return flag[:, None]


def thresholded_one_hot(idx, t_idx: int, steps: int,
                        present=None) -> np.ndarray:
    """(n, steps) float32 one-hot over the full domain grid, gated to
    rows with ``grid_index >= t_idx`` (top-k's readout round: the
    threshold gates rows, the payload width stays static)."""
    idx = np.asarray(idx, dtype=np.int64)
    n = idx.shape[0]
    out = np.zeros((n, steps), dtype=np.float32)
    keep = idx >= t_idx
    if present is not None:
        keep = keep & np.asarray(present, dtype=bool)
    rows = np.flatnonzero(keep)
    out[rows, idx[rows]] = 1.0
    return out


def quantile_rank(q: float, n_present: int) -> int:
    """The order statistic a quantile reveals: the ``rank``-th smallest
    present value with ``rank = max(1, ceil(q * n_present))``; q=0 is the
    minimum, q=1 the maximum, q=0.5 the (lower) median."""
    return max(1, int(np.ceil(q * n_present - 1e-9)))


def _host_counts(revealed, T: int, rnd: int) -> np.ndarray:
    """The first ``T`` revealed sums of round ``rnd`` as float64 on the
    host: a tensor is cut on its device and copied once."""
    if isinstance(revealed, torch.Tensor):
        flat = revealed.detach().reshape(-1)
    else:
        flat = np.asarray(revealed, dtype=np.float64).reshape(-1)
    _require(flat.shape[0] >= T,
             f"round {rnd} reveals {T} counts, got {flat.shape[0]}")
    if isinstance(flat, torch.Tensor):
        return flat[:T].cpu().numpy().astype(np.float64)
    return flat[:T]


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

class FuncRun:
    """Protocol state of one function evaluation (see the module
    docstring).  ``values`` is the (n_nodes,) vector of node-held
    scalars; ``present`` an optional (n_nodes,) bool mask of live
    contributors (default: all present)."""

    def __init__(self, fplan: FuncPlan, values, present=None):
        self.fplan = fplan
        n = fplan.cfg.n_nodes
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        values = np.asarray(values, dtype=np.float64).reshape(-1)
        _require(values.shape[0] == n,
                 f"FuncRun wants one value per node (n_nodes={n}), got "
                 f"{values.shape[0]}")
        self.values = values
        self.present = (np.ones(n, dtype=bool) if present is None
                        else np.asarray(present, dtype=bool).reshape(n))
        self.n_present = int(self.present.sum())
        self.round = 0                  # rounds fed so far
        self.done = False
        self.result = None
        self._awaiting = False          # next_payload issued, feed due
        if fplan.fn == "histogram":
            self._idx = None
        else:
            self._domain = ValueDomain(fplan.lo, fplan.hi, fplan.steps)
            self._idx = self._domain.indices(values)
            self._lo_i, self._hi_i = 0, fplan.steps - 1
            if fplan.fn == "quantile":
                self._rank = quantile_rank(fplan.q, self.n_present)
            else:                       # topk: the k-th largest
                k = min(fplan.k, self.n_present)
                self._rank = max(1, self.n_present - k + 1)
            self._t_idx = None          # topk: bisected threshold index
        if fplan.fn != "histogram" and fplan.bisect_rounds == 0:
            # one-value domain: no bisection rounds -- a quantile is done
            # at once, top-k goes straight to its readout
            self._finish()

    # -- protocol ------------------------------------------------------------
    @property
    def n_rounds(self) -> int:
        return len(self.fplan.round_elems)

    @property
    def payload_elems(self) -> int:
        """Payload length T of the round :meth:`next_payload` builds."""
        return self.fplan.round_elems[self.round]

    def next_payload(self) -> np.ndarray:
        """(n_nodes, T) float32 payload of the current round."""
        _require(not self.done, "FuncRun is done — read .result")
        _require(not self._awaiting,
                 "feed() the previous round's revealed counts first")
        self._awaiting = True
        fp = self.fplan
        if fp.fn == "histogram":
            return one_hot_payload(self.values, fp.bins, fp.lo, fp.hi,
                                   present=self.present)
        if self.round < fp.bisect_rounds:
            mid = (self._lo_i + self._hi_i) // 2
            return threshold_payload(self._idx, mid, present=self.present)
        # topk's last round: full-domain histogram above the threshold
        return thresholded_one_hot(self._idx, self._t_idx, fp.steps,
                                   present=self.present)

    def feed(self, revealed) -> None:
        """Consume the revealed aggregate of the current round's payload
        (numpy, or a tensor on any device) and advance the state."""
        _require(self._awaiting,
                 "feed() without a pending round — call next_payload()")
        self._awaiting = False
        fp = self.fplan
        T = fp.round_elems[self.round]
        counts = np.rint(_host_counts(revealed, T, self.round)).astype(
            np.int64)
        if fp.fn == "histogram":
            self.result = counts
            self.round += 1
            self.done = True
            return
        if self.round < fp.bisect_rounds:
            mid = (self._lo_i + self._hi_i) // 2
            if int(counts[0]) >= self._rank:
                self._hi_i = mid
            else:
                self._lo_i = mid + 1
            self.round += 1
            if self.round == fp.bisect_rounds:
                self._finish()
            return
        # topk readout: walk the bins from the top, expanding counts
        self.round += 1
        k = min(fp.k, self.n_present)
        vals: list[float] = []
        for b in range(fp.steps - 1, -1, -1):
            if counts[b] > 0:
                vals.extend([self._domain.value(b)] * int(counts[b]))
                if len(vals) >= k:
                    break
        self.result = np.asarray(vals[:k], dtype=np.float64)
        self.done = True

    def _finish(self) -> None:
        """Bisection exhausted: the interval is one grid value wide."""
        fp = self.fplan
        t_idx = min(self._lo_i, fp.steps - 1)
        if fp.fn == "quantile":
            self.result = self._domain.value(t_idx)
            self.done = True
        else:                           # topk continues to the readout
            self._t_idx = t_idx
