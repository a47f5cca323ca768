"""Span/event flight recorder: the protocol's causal history as a ring
buffer of plain-dict events plus an optional JSONL sink.

Counterpart of ``repro/obs/trace.py``.  The recorder never sits inside
the engine: the service executor emits events at its dispatch boundaries
(host side, after the device sync) and reconstructs the per-round wire
account from the SAME arithmetic the engine's ``Transport._account``
uses (``core.plan.hop_wire_words``), so the summed ``kind="round"``
events of a batch equal the executed ``Transport.bytes_sent`` exactly,
by construction.  Under a :class:`TickClock` the port's JSONL is byte
for byte the reference's for the same run: both executors read the
recorder's clock at the same points, in the same order.

Event kinds (see the README "Observability" table):

  * ``batch``  — one executed dispatch: retry unit/attempt, backend,
    sids, rows, padded T, schedule/transport, total wire bytes, whether
    the executable was freshly built;
  * ``round``  — one voted hop of that dispatch: round index,
    payload/digest/backup wire bytes, modeled vote disagreements /
    digest mismatches, per-mode fault-mask population;
  * ``stage``  — one timed span (admission_wait / plan_compile /
    device_dispatch / reveal);
  * ``flush`` / ``expire`` / ``shed`` — admission-queue decisions;
  * ``chaos`` / ``retry`` / ``bisect`` / ``quarantine`` / ``degrade`` /
    ``breaker`` — the resilience ladder, so a quarantined session's
    full history is reconstructible from the log.

Determinism: events are serialized with sorted keys and canonical
separators, and the clock is injectable — a :class:`TickClock` plus a
fixed chaos seed makes a replayed run produce a byte-identical JSONL
(the chaos-lane asserts this by digest).  Wall-clock recorders are for
humans; deterministic recorders are for conformance.
"""
from __future__ import annotations

import collections
import io
import json
import time
from typing import Callable, Optional

from repro_torch.core.byzantine import parse_mode
from repro_torch.core.plan import AggPlan, hop_wire_words


class TickClock:
    """Deterministic logical clock: each call returns ``start``,
    ``start + step``, ... — what replayable recorders and tests inject
    instead of ``time.monotonic``."""

    def __init__(self, step: float = 1.0, start: float = 0.0):
        self.step = step
        self.now = start - step

    def __call__(self) -> float:
        self.now += self.step
        return self.now


class TraceRecorder:
    """Bounded in-memory event ring + optional JSONL sink.

    ``sink`` is a path (opened/owned by the recorder) or any writable
    text file object (borrowed).  ``clock`` stamps every event's ``ts``
    and is also what obs-aware components time their stages with, so one
    injected clock makes the whole trace deterministic."""

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 sink=None):
        self.clock = clock
        self.events_recorded = 0
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._owns_sink = isinstance(sink, (str, bytes))
        self._sink = (open(sink, "w") if self._owns_sink else sink)

    def event(self, kind: str, **fields) -> dict:
        """Record one event; returns the dict (already in the ring)."""
        evt = {"ts": self.clock(), "kind": kind}
        evt.update(fields)
        self._ring.append(evt)
        self.events_recorded += 1
        if self._sink is not None:
            self._sink.write(json.dumps(evt, sort_keys=True,
                                        separators=(",", ":")) + "\n")
        return evt

    def events(self, kind: Optional[str] = None) -> list:
        """Ring contents (oldest first), optionally filtered by kind."""
        if kind is None:
            return list(self._ring)
        return [e for e in self._ring if e["kind"] == kind]

    def clear(self) -> None:
        self._ring.clear()

    def close(self) -> None:
        if self._sink is not None:
            self._sink.flush()
            if self._owns_sink:
                self._sink.close()
            self._sink = None


def _mask_population(masks: dict) -> dict:
    """{mode: (R, n) bool} -> {mode: int} total corrupt cells."""
    return {mode: int(m.sum()) for mode, m in masks.items()}


# Per-(plan cfg, padded) round-event payload skeleton: the per-round
# ``hop_wire_words`` splits are static per plan/padded-length, so they
# are computed ONCE here instead of once per hop per executed batch —
# the recorder hot path then only scales by the row count.  Keyed by
# the (hashable, frozen) AggConfig — the same identity ``compile_plan``
# memoizes plans under — plus the padded length; bounded like the plan
# cache.
_ROUND_WORDS_CACHE: dict = {}


def _round_words(plan: AggPlan, padded: int) -> list:
    key = (plan.cfg, padded)
    rows = _ROUND_WORDS_CACHE.get(key)
    if rows is None:
        rows = [hop_wire_words(plan.cfg, rnd, padded)
                for rnd in plan.rounds]
        if len(_ROUND_WORDS_CACHE) > 256:
            _ROUND_WORDS_CACHE.clear()
        _ROUND_WORDS_CACHE[key] = rows
    return rows


def record_batch_trace(rec: TraceRecorder, plan: AggPlan, *, padded: int,
                       rows: int, masks: dict, unit: int, attempt: int,
                       backend: str, sids: tuple, fresh: bool) -> None:
    """Emit the ``batch`` event plus one ``round`` event per voted hop
    for one *executed* dispatch of ``rows`` batch rows of ``padded``
    elements.

    Wire bytes per round come from ``hop_wire_words`` — the identical
    arithmetic ``Transport._account`` accumulated at trace time — times
    the executed row count, so summing the round events of a batch
    reproduces the engine's ``bytes_sent`` for that execution exactly.

    ``vote_disagreements`` / ``digest_mismatches`` are *modeled* from
    the batch's fault-mask population (corrupt (row, node) cells whose
    mode is active at that round — the same masks the kernels apply),
    not device readbacks: reading per-round vote outcomes back would
    put a host sync between the engine's launches."""
    cfg = plan.cfg
    total = plan.wire_bytes(padded, S=rows)
    rec.event("batch", unit=unit, attempt=attempt, backend=backend,
              sids=list(sids), rows=rows, padded=padded,
              schedule=cfg.schedule, transport=cfg.transport,
              bytes=total, rounds=len(plan.rounds), fresh=fresh)
    # mask populations are constant across rounds: sum each mode once
    parsed = [(mode, parse_mode(mode), int(m.sum()))
              for mode, m in masks.items()]
    words = _round_words(plan, padded)   # static per (plan, padded)
    for ri, rnd in enumerate(plan.rounds):
        w = words[ri]
        active = {mode: pop for mode, (base, frm), pop in parsed
                  if ri >= frm}
        mismatches = sum(
            pop for mode, (base, frm), pop in parsed
            if ri >= frm and base in ("mismatch", "equivocate"))
        rec.event("round", unit=unit, attempt=attempt, round=ri,
                  payload_bytes=4 * w["payload"] * rows,
                  digest_bytes=4 * w["digest"] * rows,
                  backup_bytes=4 * w["backup"] * rows,
                  bytes=4 * (w["payload"] + w["digest"] + w["backup"])
                  * rows,
                  vote_disagreements=sum(active.values()),
                  digest_mismatches=(mismatches
                                     if cfg.transport == "digest" else 0),
                  fault_population=active)


def record_func_round(rec: TraceRecorder, *, fn: str, rnd: int,
                      rounds: int, elems: int, bytes: int, backend: str,
                      fid=None, sid=None) -> None:
    """Emit one ``func_round`` event: one span a protocol round of a
    secure function (``repro_torch.funcs``), a bisection halving or the
    one-hot round of a histogram / top-k readout.

    The engine dispatch under it already emitted its ``batch`` and
    ``round`` events; this span ties those hops to the function round
    that caused them.  ``bytes`` is the round's analytic account
    (``AggPlan.wire_bytes`` at the round's payload length), the same
    arithmetic ``cost(fn=...)`` sums.  ``fid`` tags the function session
    (service path), ``sid`` the inner session the round rode on (None on
    the one-shot verbs)."""
    rec.event("func_round", fn=fn, round=rnd, rounds=rounds, elems=elems,
              bytes=bytes, backend=backend, fid=fid, sid=sid)


def read_jsonl(path_or_file) -> list:
    """Parse a JSONL event stream back into dicts (replay tooling)."""
    if isinstance(path_or_file, (str, bytes)):
        with open(path_or_file) as f:
            return [json.loads(line) for line in f if line.strip()]
    return [json.loads(line) for line in path_or_file if line.strip()]


def to_jsonl(events) -> str:
    """Canonical JSONL of an event list — same bytes the sink writes."""
    buf = io.StringIO()
    for e in events:
        buf.write(json.dumps(e, sort_keys=True, separators=(",", ":")))
        buf.write("\n")
    return buf.getvalue()
