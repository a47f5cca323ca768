"""Multi-round function sessions: bisection driven across pump cycles.

Counterpart of ``repro/funcs/session.py``.  A :class:`FuncSession` is
the service-side face of a :class:`~repro_torch.core.plan.FuncPlan`:
nodes contribute scalars, and each protocol round becomes one inner
:class:`~repro_torch.service.Session` of the ordinary aggregation
service, opened, contributed, sealed and batched by the admission queue
like any other query.  Concurrent function sessions whose current rounds
share a payload length share an executor batch (S concurrent medians
cost one batched dispatch a round, not S), and the resilience, chaos and
epoch machinery applies to every round unchanged.

The facade (``SecureAggregator.open_session(fn=...)``) owns the
lifecycle: its ``pump`` / ``drain`` advance the function sessions after
the service pump, so one pump cycle a bisection round moves every
in-flight function forward together:

    fs = agg.open_session(fn="median", domain=(0.0, 1.0, 1024))
    for slot in range(n):
        fs.contribute(slot, my_value[slot])
    fs.seal()
    agg.drain()            # runs every bisection round
    fs.result

A slot that never contributes is absent for the whole function; a node
departing mid-function becomes the engine's epoch-injected crash,
absorbed by the vote, so later rounds still carry its indicator rows.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.plan import FuncPlan
from repro_torch.core.schedules import _require
from repro_torch.funcs.run import FuncRun
from repro_torch.service.session import SessionState

__all__ = ["FuncSession"]


class FuncSession:
    """One in-flight secure function evaluation (see the module
    docstring).  States: ``"open"`` (accepting scalars) -> ``"running"``
    (rounds in flight as inner sessions) -> ``"done"`` (``result``
    readable) or ``"failed"`` (an inner round FAILED / EXPIRED;
    ``failed_reason`` says which and why)."""

    def __init__(self, agg, fplan: FuncPlan, fid: int,
                 ttl: Optional[float] = None):
        self._agg = agg
        self.fplan = fplan
        self.fid = fid
        self._ttl = ttl
        n = fplan.cfg.n_nodes
        self._values = np.zeros(n, dtype=np.float64)
        self._present = np.zeros(n, dtype=bool)
        self._run: Optional[FuncRun] = None
        self._inner = None              # the current round's Session
        self.state = "open"
        self.failed_reason: Optional[str] = None

    # -- contribution --------------------------------------------------------
    def contribute(self, slot: int, value: float) -> None:
        """Record slot's scalar input (before :meth:`seal`)."""
        _require(self.state == "open",
                 f"function session {self.fid} is {self.state}, not open")
        n = self.fplan.cfg.n_nodes
        _require(0 <= slot < n, f"slot {slot} out of range [0, {n})")
        self._values[slot] = float(value)
        self._present[slot] = True

    def seal(self, now: Optional[float] = None) -> None:
        """Freeze the input set and launch the first protocol round."""
        _require(self.state == "open",
                 f"function session {self.fid} is {self.state}, not open")
        self._run = FuncRun(self.fplan, self._values,
                            present=self._present)
        self.state = "running"
        if self._run.done:              # zero-round degenerate domain
            self.state = "done"
        else:
            self._open_round(now)

    # -- round machinery -----------------------------------------------------
    def _open_round(self, now) -> None:
        payload = self._run.next_payload()
        T = payload.shape[1]
        inner = self._agg.open_session(T, now=now, ttl=self._ttl)
        for slot in np.flatnonzero(self._present):
            inner.contribute(int(slot), payload[slot])
        self._agg.seal(inner.sid, now=now)
        self._inner = inner

    def advance(self, now: Optional[float] = None) -> bool:
        """Feed a revealed inner round and launch the next; called by the
        facade after each service pump.  True when the session
        progressed (a round fed, finished, or failed)."""
        if self.state != "running" or self._inner is None:
            return False
        st = self._inner.state
        if st in (SessionState.FAILED, SessionState.EXPIRED):
            self.failed_reason = (f"round {self._run.round} inner session "
                                  f"{self._inner.sid} {st.value}: "
                                  f"{self._inner.failed_reason}")
            self._inner = None
            self.state = "failed"
            return True
        if st is not SessionState.REVEALED:
            return False                # still queued / aggregating
        sid = self._inner.sid
        self._inner = None
        revealed = self._agg.result(sid, evict=True)
        T = self._run.payload_elems
        rnd = self._run.round
        self._run.feed(revealed)
        rec = self._agg.recorder
        if rec is not None:
            from repro_torch.obs.trace import record_func_round
            plan, _ = self._agg._plan_for(T)
            record_func_round(rec, fn=self.fplan.fn, rnd=rnd,
                              rounds=self._run.n_rounds, elems=T,
                              bytes=plan.wire_bytes(T),
                              backend=self._agg.backend, fid=self.fid,
                              sid=sid)
        if self._run.done:
            self.state = "done"
        else:
            self._open_round(now)
        return True

    # -- results -------------------------------------------------------------
    @property
    def done(self) -> bool:
        return self.state == "done"

    @property
    def result(self):
        """The revealed result (histogram counts int64, quantile float,
        top-k float array, descending)."""
        _require(self.state == "done",
                 f"function session {self.fid} is {self.state}; pump/"
                 "drain until done")
        return self._run.result

    @property
    def rounds_run(self) -> int:
        """Protocol rounds fed so far (= engine allreduces executed)."""
        return 0 if self._run is None else self._run.round

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FuncSession(fid={self.fid}, fn={self.fplan.fn}, "
                f"state={self.state}, rounds={self.rounds_run}/"
                f"{0 if self._run is None else self._run.n_rounds})")
