"""Deterministic runtime-fault injection for the service executor.

Counterpart of ``repro/runtime/chaos.py``: the same modes, knobs and
splitmix decision stream, so one seed arms the same attempts on both
sides.

The protocol-level adversaries (``core.byzantine``) corrupt *bits on
the wire* and are absorbed by the vote; this module injects the faults
the vote cannot see — the dispatch itself failing.  Four modes:

  * ``"dispatch"`` — the executor raises :class:`ChaosError` before the
    batch is dispatched (a crashed worker / lost RPC);
  * ``"compile"``  — the raise happens at executable-build time (the
    reference's XLA compile failure; here the batch executable's build);
  * ``"hop"``      — :class:`ChaosTransport` wraps the engine transport
    and raises at voted round ``hop_k`` (a collective dying mid-plan);
    the executor runs such attempts outside its executable cache so the
    fault fires on *every* armed attempt, on the sim oracle and — via
    ``MeshTransport(wrap_inner=...)`` — inside every rank alike;
  * ``"slow"``     — the dispatch sleeps ``slow_s`` first, which a
    ``RetryPolicy.deadline_s`` then converts into a retriable
    :class:`~repro_torch.runtime.resilience.DeadlineExceeded`.

Arming is **deterministic and replayable**: a :class:`ChaosSchedule`
draws one splitmix-seeded decision per dispatch attempt, so a seed
pins the whole failure schedule (the chaos-lane sweeps a fixed seed
set).  Targeting knobs: ``times`` caps total injections (``times=1``
= "fail the first attempt, recover on retry"), ``poison_sids`` fires
only when the batch contains one of those sessions (what the bisection
tests use to pin quarantine to the poison session), ``only_backend``
restricts injection to the mesh or sim dispatch path (what the
circuit-breaker tests use to fail the mesh while the sim fallback
stays healthy).

Chaos faults never corrupt payloads — they raise or delay — so any
attempt that *completes* is bit-identical to a fault-free run by
construction; the conformance tests pin exactly that.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.runtime.resilience import _mix32, _require

CHAOS_MODES = ("dispatch", "compile", "hop", "slow")


class ChaosError(RuntimeError):
    """An injected runtime fault (never raised outside chaos testing)."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """One fault-injection rule, armed per dispatch attempt.

    ``p`` is the per-attempt injection probability, drawn
    deterministically from ``seed`` and the attempt counter; the
    targeting knobs (``times`` / ``poison_sids`` / ``only_backend``)
    AND-combine with it."""
    mode: str = "dispatch"            # dispatch | compile | hop | slow
    p: float = 1.0                    # per-attempt injection probability
    seed: int = 0
    times: Optional[int] = None       # max injections (None = unbounded)
    hop_k: int = 0                    # voted round index for mode="hop"
    # (round 0 exists in every plan; small topologies compile to a
    # single voted round, so a higher default would silently never fire)
    slow_s: float = 0.0               # sleep for mode="slow"
    poison_sids: tuple = ()           # fire only on batches holding these
    only_backend: Optional[str] = None  # fire only on this dispatch path

    def __post_init__(self):
        _require(self.mode in CHAOS_MODES,
                 f"unknown chaos mode {self.mode!r}; pick one of "
                 f"{list(CHAOS_MODES)}")
        _require(0.0 <= self.p <= 1.0,
                 f"chaos p must be in [0, 1], got {self.p}")
        _require(self.times is None or self.times >= 0,
                 f"chaos times must be >= 0 (or None), got {self.times}")
        _require(self.hop_k >= 0,
                 f"chaos hop_k must be >= 0, got {self.hop_k}")
        _require(self.slow_s >= 0,
                 f"chaos slow_s must be >= 0, got {self.slow_s}")
        _require(self.only_backend in (None, "sim", "mesh"),
                 f"chaos only_backend must be None, 'sim' or 'mesh', got "
                 f"{self.only_backend!r}")
        object.__setattr__(self, "poison_sids", tuple(self.poison_sids))


class ChaosSchedule:
    """Stateful per-executor arming of one :class:`ChaosConfig`.

    ``decide`` is called once per dispatch attempt and returns the
    config when the fault fires.  The decision stream is a pure
    function of (seed, attempt counter), so a fixed seed replays the
    same failure schedule — the property the chaos-lane's seed sweep
    leans on."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self.decisions = 0                # dispatch attempts seen
        self.injected = 0                 # faults actually armed

    def decide(self, sessions: Sequence, backend: str) \
            -> Optional[ChaosConfig]:
        cfg = self.cfg
        self.decisions += 1
        if cfg.times is not None and self.injected >= cfg.times:
            return None
        if cfg.only_backend is not None and backend != cfg.only_backend:
            return None
        if cfg.poison_sids and not any(
                s.sid in cfg.poison_sids for s in sessions):
            return None
        if cfg.p < 1.0:
            u = _mix32(cfg.seed, self.decisions) / float(1 << 32)
            if u >= cfg.p:
                return None
        self.injected += 1
        return cfg


class ChaosTransport:
    """Engine-transport proxy that raises at voted round ``hop_k``.

    Wraps any object satisfying the :class:`~repro_torch.core.engine.
    Transport` protocol (SimTransport directly; ManualTransport via
    ``MeshTransport(wrap_inner=...)`` in every rank) and
    delegates everything except :meth:`hop`, which raises
    :class:`ChaosError` when the armed round comes up — modeling a
    collective that dies mid-plan.  Payloads are never touched, so a
    hop that is *not* armed is bit-identical to the bare transport."""

    def __init__(self, inner, fault: Optional[ChaosConfig]):
        self._inner = inner
        self._fault = fault

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def hop(self, rnd, rnd_idx, meta, acc):
        f = self._fault
        if f is not None and f.mode == "hop" and rnd_idx == f.hop_k:
            raise ChaosError(
                f"chaos: injected transport failure at voted hop "
                f"{rnd_idx}")
        return self._inner.hop(rnd, rnd_idx, meta, acc)
