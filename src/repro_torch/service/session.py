"""Aggregation-session engine — one session per query.

Counterpart of ``repro/service/session.py``: the same lifecycle, batch
key, pad-key derivation and payload packing.  Contributions are host
data (float32 numpy vectors; a torch tensor is copied to the host), and
so is a revealed result (a CPU float32 tensor, sliced from the batch's
pinned result buffer).  ``derive_session_seed`` and the pad offsets are
uint32 arithmetic on Python ints, masked to 32 bits, never torch uint32.

The paper's protocol aggregates one query over one network; the service
turns that into a *stream* of queries: every session is an independent
secure aggregation with an explicit lifecycle

    open -> contribute -> seal -> aggregate -> reveal

and carries its own pad-stream key (derived from the service seed and the
session id with the same splitmix32 mixer the kernels use), a pad-stream
counter offset, its quantization config, and its vote redundancy.
Sessions that share a :class:`BatchKey` (identical static protocol
parameters and padded payload length) can be packed by the executor into
one (S, T) batched kernel dispatch.

A slot that never contributes by seal time is treated as crashed: its
payload counts as zero and its ring copies are dropped — resolved by the
vote path, exactly like a mid-session crash injected via
``runtime.fault.SessionFaultPlan``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

import torch

from repro_torch.core.plan import AggConfig, _require
from repro_torch.runtime.fault import SessionFaultPlan

_MASK32 = 0xFFFFFFFF


def derive_session_seed(base_seed: int, session_id: int) -> int:
    """Per-session pad-stream key: the kernels' splitmix32 mixer applied
    to (base_seed, session_id) — distinct sessions never share a pad
    stream even at identical counter offsets."""
    x = (base_seed ^ (session_id * 0x85EBCA6B)) & _MASK32
    x = (x + 0x9E3779B9) & _MASK32
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & _MASK32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & _MASK32
    return (x ^ (x >> 16)) & _MASK32


class SessionState(enum.Enum):
    OPEN = "open"                # accepting contributions
    SEALED = "sealed"            # admitted to the scheduler queue
    AGGREGATING = "aggregating"  # packed into an executing batch
    REVEALED = "revealed"        # result available
    FAILED = "failed"            # executor error (after retry/quarantine)
    EXPIRED = "expired"          # deadline passed / shed by admission


class LifecycleError(RuntimeError):
    """An operation was attempted in the wrong session state."""


@dataclasses.dataclass(frozen=True)
class SessionParams:
    """Static protocol parameters of one session.  Everything here is
    part of the batch key — sessions must agree on all of it (plus the
    padded payload length) to share one (S, T) executor batch."""
    n_nodes: int
    elems: int                    # payload length T (per-node vector)
    cluster_size: int = 4
    redundancy: int = 3           # r odd, <= cluster_size
    schedule: str = "ring"
    clip: float = 1.0
    guard_bits: int = 2
    masking: str = "global"       # global | pairwise | none
    # wire transport of the voted hops: "full" ships r payload copies,
    # "digest" ships 1 payload + r digests + the compiled backup stream
    # (the paper's bandwidth mechanism) — part of the batch key, so
    # sessions on different transports never share an executor batch
    transport: str = "full"       # full | digest
    digest_words: int = 16
    digest_backup: bool = True

    def __post_init__(self):
        _require(self.elems >= 1,
                 f"session payload length elems must be >= 1, got "
                 f"{self.elems}")
        # the protocol knobs validate as one config (raises ConfigError)
        self.agg_config()

    @classmethod
    def from_config(cls, cfg: AggConfig, elems: int) -> "SessionParams":
        """Derive session parameters from the shared protocol config —
        the facade's ``open_session`` path: every protocol knob has ONE
        home (the config sections), sessions only add the payload
        length."""
        _require(isinstance(cfg, AggConfig),
                 f"from_config needs an AggConfig, got {type(cfg).__name__}")
        return cls(n_nodes=cfg.n_nodes, elems=elems,
                   cluster_size=cfg.cluster_size, redundancy=cfg.redundancy,
                   schedule=cfg.schedule, clip=cfg.clip,
                   guard_bits=cfg.guard_bits, masking=cfg.masking,
                   transport=cfg.transport, digest_words=cfg.digest_words,
                   digest_backup=cfg.digest_backup)

    def agg_config(self, kernel_impl: Optional[str] = None) -> AggConfig:
        return AggConfig(n_nodes=self.n_nodes,
                         cluster_size=self.cluster_size,
                         redundancy=self.redundancy, schedule=self.schedule,
                         transport=self.transport,
                         digest_words=self.digest_words,
                         digest_backup=self.digest_backup,
                         masking=self.masking, clip=self.clip,
                         guard_bits=self.guard_bits,
                         kernel_impl=kernel_impl)

    def batch_key(self, padded_elems: int) -> tuple:
        return (self.n_nodes, self.cluster_size, self.redundancy,
                self.schedule, self.clip, self.guard_bits, self.masking,
                self.transport, self.digest_words, self.digest_backup,
                padded_elems)


class Session:
    """One aggregation query in flight.

    Created by the service facade (which pins it to the current overlay
    epoch); nodes ``contribute`` their payload by protocol slot; ``seal``
    freezes the input set and hands the session to the admission queue;
    the executor moves it through AGGREGATING to REVEALED.
    """

    def __init__(self, sid: int, params: SessionParams, seed: int,
                 pad_offset: int = 0, epoch: Optional[object] = None,
                 opened_at: float = 0.0,
                 expires_at: Optional[float] = None):
        self.sid = sid
        self.params = params
        self.seed = int(seed) & _MASK32
        self.pad_offset = int(pad_offset) & _MASK32
        self.epoch = epoch            # EpochSnapshot this session is pinned to
        self.opened_at = opened_at
        # deadline (same clock as opened_at/sealed_at): a session still
        # queued past this point moves to EXPIRED at pump time instead
        # of aggregating; None = no deadline
        self.expires_at = expires_at
        self.sealed_at: Optional[float] = None
        self.state = SessionState.OPEN
        self.fault = SessionFaultPlan()
        self.failed_reason: Optional[str] = None
        self._contrib: dict[int, np.ndarray] = {}
        self._slots: Optional[tuple[int, ...]] = None
        self._result: Optional[torch.Tensor] = None

    # -- lifecycle ----------------------------------------------------------
    def _require(self, *states: SessionState) -> None:
        if self.state not in states:
            raise LifecycleError(
                f"session {self.sid}: {self.state.value} not in "
                f"{[s.value for s in states]}")

    def contribute(self, slot: int, value) -> None:
        """Record slot's payload (float vector of ``params.elems``)."""
        self._require(SessionState.OPEN)
        if not 0 <= slot < self.params.n_nodes:
            raise ValueError(f"slot {slot} out of range")
        if isinstance(value, torch.Tensor):
            value = value.detach().to("cpu", torch.float32).numpy()
        vec = np.asarray(value, np.float32).reshape(-1)
        if vec.shape[0] != self.params.elems:
            raise ValueError(
                f"payload length {vec.shape[0]} != elems {self.params.elems}")
        self._contrib[slot] = vec

    def inject_fault(self, plan: SessionFaultPlan) -> None:
        """Merge mid-session faults (crashes / Byzantine flips)."""
        self._require(SessionState.OPEN, SessionState.SEALED)
        self.fault = self.fault.merge(plan)

    def seal(self, now: float = 0.0) -> None:
        """Freeze the input set.  Slots that never contributed are
        marked crashed (zero payload + dropped ring copies)."""
        self._require(SessionState.OPEN)
        missing = tuple(sorted(set(range(self.params.n_nodes))
                               - set(self._contrib)))
        if missing:
            self.fault = self.fault.merge(
                SessionFaultPlan(crashed_slots=missing))
        self._slots = tuple(sorted(self._contrib))
        self.state = SessionState.SEALED
        self.sealed_at = now

    def payload_matrix(self, padded_elems: int) -> np.ndarray:
        """(n_nodes, padded_elems) float32 contributions, zero-filled for
        missing slots and for the pad tail beyond ``params.elems``."""
        self._require(SessionState.SEALED, SessionState.AGGREGATING)
        out = np.zeros((self.params.n_nodes, padded_elems), np.float32)
        for slot, vec in self._contrib.items():
            out[slot, : self.params.elems] = vec
        return out

    def n_rows(self, row_elems: int) -> int:
        """Batch rows this session occupies at ``row_elems`` per row —
        long payloads chunk across rows (the per-session counter offsets
        keep the chunked pad streams identical to a monolithic run)."""
        return max(1, -(-self.params.elems // row_elems))

    def payload_rows(self, row_elems: int) -> list[np.ndarray]:
        """Split the payload into ``n_rows`` (n_nodes, row_elems)
        matrices; row j covers flat positions [j*row_elems, ...)."""
        k = self.n_rows(row_elems)
        full = self.payload_matrix(k * row_elems)
        return [full[:, j * row_elems:(j + 1) * row_elems]
                for j in range(k)]

    def fill_payload_rows(self, out: np.ndarray, start: int,
                          row_elems: int) -> int:
        """Write this session's payload rows into
        ``out[start:start + k]`` ((·, n_nodes, row_elems) float32) in
        place — same values as :meth:`payload_rows`, no intermediate
        (n_nodes, padded) allocation.  Every byte of the target rows is
        written (missing slots and the pad tail are zero-filled), so
        the caller may hand over a recycled batch-slot buffer without
        pre-zeroing it.  Returns ``k``, the rows consumed."""
        self._require(SessionState.SEALED, SessionState.AGGREGATING)
        k = self.n_rows(row_elems)
        e = self.params.elems
        for slot in range(self.params.n_nodes):
            vec = self._contrib.get(slot)
            for j in range(k):
                row = out[start + j, slot]
                if vec is None:
                    row[:] = 0
                    continue
                lo = j * row_elems
                n = min(e, lo + row_elems) - lo
                if n > 0:
                    row[:n] = vec[lo:lo + n]
                if n < row_elems:
                    row[max(n, 0):] = 0
        return k

    def mark_aggregating(self) -> None:
        self._require(SessionState.SEALED)
        self.state = SessionState.AGGREGATING

    def reveal(self, revealed: torch.Tensor) -> None:
        self._require(SessionState.AGGREGATING)
        self._result = revealed[: self.params.elems]
        self._contrib.clear()   # payloads are dead weight once revealed
        self.state = SessionState.REVEALED

    def fail(self, reason: str = "") -> None:
        self.state = SessionState.FAILED
        self.failed_reason = reason
        self._contrib.clear()

    def expire(self, reason: str = "deadline") -> None:
        """Retire an un-executed session (deadline passed, or shed by
        the admission queue's load watermark).  Only sensible before
        aggregation starts — a dispatched batch either reveals or
        fails."""
        self._require(SessionState.OPEN, SessionState.SEALED)
        self.state = SessionState.EXPIRED
        self.failed_reason = reason
        self._contrib.clear()

    def expired(self, now: float) -> bool:
        return self.expires_at is not None and now >= self.expires_at

    @property
    def result(self) -> torch.Tensor:
        self._require(SessionState.REVEALED)
        return self._result

    @property
    def contributed_slots(self) -> tuple[int, ...]:
        return (self._slots if self._slots is not None
                else tuple(sorted(self._contrib)))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Session(sid={self.sid}, state={self.state.value}, "
                f"n={self.params.n_nodes}, T={self.params.elems})")
