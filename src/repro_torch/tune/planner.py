"""Self-tuning planner: the exact wire-byte account as a scoring oracle.

Counterpart of ``repro/tune/planner.py``: the same grid, scores, ranking
key and memo, so every decision equals the JAX package's field for
field.  The measured mode times its finalists on the facade's device
(CUDA events on the card).

The paper's O(n·log³ n) communication bound only materializes when the
schedule/transport/digest knobs fit the workload; until now a human
picked them.  This module turns every exposed knob into something the
system sets for you: given a
:class:`~repro_torch.tune.WorkloadSignature`, :class:`Tuner` enumerates
the candidate grid over

    schedule {ring, tree, butterfly} x transport {full, digest}
    x digest_words x chunk_elems x pad buckets x digest_backup

and scores every candidate with the EXACT cost oracle — the same
``AggPlan.wire_bytes`` account the engine's ``Transport.bytes_sent``
accumulates at trace time and ``schedules.schedule_cost`` computes
analytically (the conformance suite pins all three equal).  The chosen
config's predicted score therefore equals its executed bytes bit for
bit; ``tests/test_tune.py`` pins that equality over a golden decision
table.  Candidates whose committee shape a schedule cannot serve (e.g.
tree on a non-power-of-two cluster count) raise
:class:`~repro_torch.core.plan.ConfigError` and are skipped, a
catchable typed error (the schedule builders never use a bare ``assert``).

Two scores ride on each candidate:

  * ``predicted_bytes`` — the exact honest-path wire bytes the config
    moves at the signature's (padded T, S).  This is what an executed
    run's ``Transport.bytes_sent`` shows.
  * ``expected_bytes``  — the ranking score: ``predicted_bytes`` plus,
    for detect-only digest candidates (``digest_backup=False``), the
    *expected* cost of retransmission rounds under the signature's
    corruption rate.  This is the adaptive digest-backup tradeoff: the
    backup stream is compiled in exactly when
    the byzantine budget (plus churn) makes detect-only retransmission
    expected-cost-worse than shipping the backup eagerly.

An optional measured mode (``Tuner(probe=True)``) times ONE real
batched dispatch per byte-score finalist and picks the fastest: bytes
are an excellent proxy but not the whole truth once kernels and dispatch
overheads enter.

Decisions are memoized in a module-wide cache keyed by (signature,
normalized base config), next to ``core.plan``'s plan cache and with
the same ``stats()``/``clear()`` surface: a facade cache hit is one dict
lookup, cheap enough for the per-dispatch resolution path.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from repro_torch.core.plan import (AggConfig, ConfigError, compile_plan,
                                   hop_wire_words)
from repro_torch.kernels.backend import resolve_device
from repro_torch.obs import metrics as _obs
from repro_torch.tune.signature import WorkloadSignature

# candidate axes.  digest_words trades wire bytes against collision
# resistance, so the byte oracle alone would always pick the narrowest
# digest; _min_digest_words applies the security floor first.
SCHEDULE_GRID = ("ring", "tree", "butterfly")
DIGEST_WORDS_GRID = (8, 16, 32)
CHUNK_GRID = (1 << 14, 1 << 16, 1 << 18)
# tuned pads quantize T to the kernels' (8, 128) lane width instead of
# the service's coarse power-of-four buckets — the win on mid-range T
# is real bytes (T=1100 pads to 1152, not 4096)
PAD_QUANTUM = 128
# the service's default coarse buckets (BatchingConfig.pad_buckets) —
# kept as a candidate so a tuned run never pads tighter than it
# executes, and mirrored (not imported) to keep repro_torch.tune
# importable without the service stack
DEFAULT_PAD_BUCKETS = (64, 256, 1024, 4096, 16384)
# where probe_report=True writes its tables: None is the hillclimb
# report directory (``launch.hillclimb.PERF_DIR``, as the
# reference writes into its own), read when a report is written so that
# importing the tuner imports no launcher
PROBE_DIR = None


def _bucket_padded(elems: int, buckets=DEFAULT_PAD_BUCKETS) -> int:
    for b in buckets:
        if elems <= b:
            return b
    top = buckets[-1]
    return ((elems + top - 1) // top) * top


def pad_candidates(T: int) -> tuple[int, ...]:
    """The pad axis: the tight kernel-lane multiple and the service's
    default coarse bucket (deduped, ascending)."""
    tight = max(PAD_QUANTUM, ((T + PAD_QUANTUM - 1) // PAD_QUANTUM)
                * PAD_QUANTUM)
    return tuple(sorted({tight, _bucket_padded(T)}))


def _min_digest_words(sig: WorkloadSignature) -> int:
    """Security floor of the digest width.  A digest is the vote's only
    view of a payload, so its collision resistance must scale with the
    adversary: 8 words (256 bits) suffice against accidents, an active
    byzantine budget needs 16, and a budget above a quarter of the
    committee gets 32 — the byte oracle then picks the narrowest
    allowed width."""
    if sig.byzantine_budget == 0 and sig.churn_rate == 0.0:
        return DIGEST_WORDS_GRID[0]
    if sig.byzantine_budget > sig.n_nodes // 4:
        return DIGEST_WORDS_GRID[2]
    return DIGEST_WORDS_GRID[1]


def expected_retransmit_bytes(plan, padded: int,
                              sig: WorkloadSignature) -> float:
    """Expected extra wire bytes of the detect-only digest path
    (``digest_backup=False``) under the signature's corruption rate.

    A digest-rejected payload cannot be fetched lazily under SPMD: the
    affected round replays in full (1 payload + r digests per receiving
    member), and a replay round draws its streams from the same
    committee, so it is tainted again with the same probability — the
    expected number of replays is the geometric ``p / (1 - p)`` at
    per-round taint probability ``p = 1 - (1 - q)^receivers`` over the
    round's member-level receives (per-stream corruption rate ``q`` =
    :meth:`WorkloadSignature.corruption_rate`).  At q = 0 this is 0
    (detect-only always wins — the honest path is strictly cheaper);
    past the workload-dependent threshold the replay cascade dwarfs the
    one eager backup payload per receive and backup wins — the
    fault-tolerance overhead boundary of Grining et al. (1602.04138),
    decided per signature instead of by a static default."""
    q = sig.corruption_rate()
    if q <= 0.0:
        return 0.0
    total = 0.0
    for rnd in plan.rounds:
        w = hop_wire_words(plan.cfg, rnd, padded)
        receivers = len(rnd.perms[0])        # member-level receives
        p = 1.0 - (1.0 - q) ** receivers
        p = min(p, 1.0 - 1e-9)               # q -> 1: huge, not infinite
        total += (p / (1.0 - p)) * 4.0 * (w["payload"] + w["digest"])
    return total * sig.S


@dataclasses.dataclass(frozen=True)
class TuneDecision:
    """One resolved signature: the winning config and its accounts."""
    signature: WorkloadSignature
    config: AggConfig            # base config with the tuned knobs set
    padded_elems: int            # tuned row pad (the executed T)
    predicted_bytes: int         # exact honest-path wire bytes at (pad, S)
    expected_bytes: float        # ranking score incl. retransmit expectation
    baseline_bytes: int          # the paper-faithful ring/full default
    candidates_scored: int
    probed: bool = False

    @property
    def saving_vs_default(self) -> float:
        """Fraction of the ring/full default's bytes this decision
        saves (0.0 = no better)."""
        if self.baseline_bytes <= 0:
            return 0.0
        return 1.0 - self.predicted_bytes / self.baseline_bytes


# the module-wide decision memo, next to core.plan's _PLAN_CACHE — one
# resolution per (signature, normalized base config) per process
_TUNER_CACHE: dict = {}
_TUNER_STATS = {"hits": 0, "misses": 0}


def tuner_cache_stats() -> dict:
    """Hit/miss/size counters of the shared decision memo — surfaced by
    ``SecureAggregator.stats()["tuner"]``."""
    return dict(_TUNER_STATS, size=len(_TUNER_CACHE))


def clear_tuner_cache() -> None:
    _TUNER_CACHE.clear()
    _TUNER_STATS.update(hits=0, misses=0)


class Tuner:
    """Resolve workload signatures to protocol configs with the exact
    cost oracle (see the module docstring for the model).

    ``probe=True`` adds the measured mode: the top ``probe_finalists``
    byte-score candidates each run one real (warmed) batched dispatch
    on the sim transport on ``device`` (``None``: the card) and the
    fastest wins; ``last_probe`` keeps the latest table of finalists and
    their seconds.  ``probe_report=True`` also writes that table under
    :data:`PROBE_DIR` (by default ``launch.hillclimb.PERF_DIR``).  ``churn_rate`` seeds the signatures the facade
    builds as a static hint; ``epochs`` (an
    :class:`~repro_torch.service.EpochManager`) upgrades it to the
    MEASURED departure rate: signatures read
    ``epochs.observed_churn_rate()`` at build time, so a drift in real
    churn produces a new signature and a fresh decision while the stale
    one stays memoized.  ``metrics`` shares a
    :class:`~repro_torch.obs.MetricsRegistry` for the decision /
    cache-hit / probe counters."""

    def __init__(self, *, probe: bool = False, probe_finalists: int = 3,
                 probe_rows: int = 4, probe_report: bool = False,
                 churn_rate: float = 0.0, epochs=None, metrics=None,
                 device=None):
        self.probe = probe
        self.probe_finalists = max(1, probe_finalists)
        self.probe_rows = max(1, probe_rows)
        self.probe_report = probe_report
        self.churn_rate = churn_rate
        self.epochs = epochs
        self.device = device
        self.last_probe: list = []
        self.metrics = _obs.registry_or_default(metrics)
        self._c_decisions = self.metrics.counter(_obs.M_TUNER_DECISIONS)
        self._c_hits = self.metrics.counter(_obs.M_TUNER_CACHE_HITS)
        self._c_probes = self.metrics.counter(_obs.M_TUNER_PROBES)

    # -- public API ---------------------------------------------------------
    def signature(self, cfg: AggConfig, T: int,
                  S: int = 1) -> WorkloadSignature:
        return WorkloadSignature.of(cfg, T, S, churn_rate=self.churn_rate,
                                    epochs=self.epochs)

    def decide(self, cfg: AggConfig,
               sig: WorkloadSignature) -> TuneDecision:
        """The winning config for ``sig``, memoized module-wide.  The
        tuned knobs (schedule/transport/digest/chunk + pad) are chosen
        fresh; every policy knob (masking, clip, seeds, byzantine spec,
        kernel engine) is copied from ``cfg``."""
        base = self._normalize(cfg, sig)
        key = (sig, base)
        hit = _TUNER_CACHE.get(key)
        if hit is not None:
            _TUNER_STATS["hits"] += 1
            self._c_hits.inc()
            return hit
        _TUNER_STATS["misses"] += 1
        self._c_decisions.inc()
        decision = self._score(base, sig)
        _TUNER_CACHE[key] = decision
        return decision

    def resolve(self, cfg: AggConfig, T: int, S: int = 1) -> TuneDecision:
        """``decide`` with the signature built from ``cfg`` directly."""
        return self.decide(cfg, self.signature(cfg, T, S))

    def stats(self) -> dict:
        """This tuner's registry counters + the shared decision memo."""
        return {"decisions": self._c_decisions.value,
                "cache_hits": self._c_hits.value,
                "probes": self._c_probes.value,
                "cache": tuner_cache_stats()}

    # -- internals ----------------------------------------------------------
    @staticmethod
    def _normalize(cfg: AggConfig, sig: WorkloadSignature) -> AggConfig:
        """The cache-key base: ``cfg`` reclamped to the signature's
        committee with every tuned axis reset to its default, so two
        bases differing only in knobs the tuner overrides anyway share
        one cache entry."""
        if cfg.n_nodes != sig.n_nodes:
            cfg = cfg.derive(n_nodes=sig.n_nodes, schedule="ring")
        return cfg.replace(schedule="ring", transport="full",
                           digest_words=16, digest_backup=True,
                           chunk_elems=AggConfig.chunk_elems)

    def _candidates(self, base: AggConfig, sig: WorkloadSignature):
        """Yield ``(config, padded)`` over the grid; committee shapes a
        schedule cannot serve raise ConfigError and are skipped."""
        words_floor = _min_digest_words(sig)
        for schedule in SCHEDULE_GRID:
            for transport in ("full", "digest"):
                if transport == "full":
                    # digest knobs are inert on the full transport:
                    # one canonical candidate, not a words x backup fan
                    wire_axis = [(base.digest_words, True)]
                else:
                    wire_axis = [(w, b) for w in DIGEST_WORDS_GRID
                                 if w >= words_floor for b in (False, True)]
                for words, backup in wire_axis:
                    for chunk in CHUNK_GRID:
                        for padded in pad_candidates(sig.T):
                            try:
                                cand = base.replace(
                                    schedule=schedule, transport=transport,
                                    digest_words=words,
                                    digest_backup=backup,
                                    chunk_elems=chunk)
                            except ConfigError:
                                continue   # e.g. tree on non-pow2 g
                            yield cand, padded

    def _score(self, base: AggConfig,
               sig: WorkloadSignature) -> TuneDecision:
        scored = []
        for cand, padded in self._candidates(base, sig):
            plan = compile_plan(cand)
            # chunks follows the chunked-transport account (one digest
            # set per chunk), so the oracle itself prefers a chunk size
            # covering the padded row — predicted == executed for the
            # single-chunk batched dispatch the facade/service issue
            chunks = max(1, -(-padded // cand.chunk_elems))
            predicted = plan.wire_bytes(padded, S=sig.S, chunks=chunks)
            expected = float(predicted)
            if cand.transport == "digest" and not cand.digest_backup:
                expected += expected_retransmit_bytes(plan, padded, sig)
            # deterministic total order: score, then fewer rounds
            # (latency), tighter pad, smaller chunk (memory), and the
            # grid order as the final tiebreak
            key = (expected, len(plan.rounds), padded, cand.chunk_elems,
                   SCHEDULE_GRID.index(cand.schedule), cand.transport,
                   cand.digest_words, cand.digest_backup)
            scored.append((key, cand, padded, predicted, expected))
        if not scored:
            raise ConfigError(
                f"tuner found no feasible candidate for signature {sig} "
                f"over base {base} — every schedule rejected the "
                "committee shape")
        scored.sort(key=lambda t: t[0])
        _, cand, padded, predicted, expected = scored[0]
        probed = False
        if self.probe and len(scored) > 1:
            cand, padded, predicted, expected = self._probe(
                scored[: self.probe_finalists], sig)
            probed = True
        ring = compile_plan(base)            # normalized base IS ring/full
        baseline = ring.wire_bytes(_bucket_padded(sig.T), S=sig.S)
        return TuneDecision(signature=sig, config=cand,
                            padded_elems=padded,
                            predicted_bytes=predicted,
                            expected_bytes=expected,
                            baseline_bytes=baseline,
                            candidates_scored=len(scored), probed=probed)

    def _probe(self, finalists, sig: WorkloadSignature):
        """Measured mode: one warmed real dispatch per finalist on the
        sim transport (probe batches are capped at ``probe_rows`` rows:
        the ranking transfers; the point is relative kernel/dispatch
        cost, not absolute throughput).  On the card each dispatch is
        timed by CUDA events after a warm call, on the CPU by the host
        clock."""
        from repro_torch.core import engine as _engine
        from repro_torch.core.plan import SessionMeta
        dev = resolve_device(self.device)
        rows = min(sig.S, self.probe_rows)
        results = []
        for _, cand, padded, predicted, expected in finalists:
            plan = compile_plan(cand)
            xs = torch.zeros((rows, sig.n_nodes, padded),
                             dtype=torch.float32, device=dev)
            meta = SessionMeta.build(rows, sig.n_nodes, device=dev,
                                     seed=cand.seed)
            index = _engine.RoundIndex(plan, dev)
            _engine.sim_batch(plan, xs, meta, index=index)      # warm
            best = float("inf")
            for _ in range(2):
                best = min(best, _seconds(
                    lambda: _engine.sim_batch(plan, xs, meta, index=index),
                    dev))
            self._c_probes.inc()
            results.append((best, cand, padded, predicted, expected))
        results.sort(key=lambda t: t[0])
        self.last_probe = [
            {"schedule": c.schedule, "transport": c.transport,
             "digest_words": c.digest_words,
             "digest_backup": c.digest_backup,
             "chunk_elems": c.chunk_elems, "padded": padded,
             "predicted_bytes": predicted, "probe_s": best}
            for best, c, padded, predicted, _ in results]
        if self.probe_report:
            self._write_probe_report(sig)
        return results[0][1:]

    def _write_probe_report(self, sig: WorkloadSignature) -> None:
        out_dir = PROBE_DIR
        if out_dir is None:
            from repro_torch.launch.hillclimb import PERF_DIR as out_dir
        os.makedirs(out_dir, exist_ok=True)
        tag = (f"tuner_probe_n{sig.n_nodes}_T{sig.T}_S{sig.S}"
               f"_b{sig.byzantine_budget}")
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump({"signature": dataclasses.asdict(sig),
                       "finalists": self.last_probe}, f, indent=1)


def _seconds(fn, dev: torch.device) -> float:
    """Seconds of one call of ``fn``: CUDA events around it on the card
    (the stream drained first), the host clock on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
