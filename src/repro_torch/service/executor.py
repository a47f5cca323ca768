"""Batched session executor + admission scheduler (+ resilience layer).

Counterpart of ``repro/service/executor.py``.  S concurrent sessions
that share a batch key are packed into one (S, n_nodes, T_row) batch, a
plan is compiled once per shape (``core.plan.compile_plan``), and the
engine executes it on the configured transport:

  * ``transport="sim"``  — :class:`~repro_torch.core.engine.SimTransport`,
    the single-device oracle on the executor's device (default);
  * ``transport="mesh"`` — :class:`~repro_torch.core.engine.MeshTransport`
    over a :class:`~repro_torch.runtime.compat.NodeMesh`, one rank
    process per protocol node.  Every rank runs its own copy of the
    service and passes the global batch — bit-identical to the sim.

Every protocol stage is ONE batched launch over all S rows (the three
CUDA kernels on a CUDA device), and all masking modes run batched.

The executor's "executable" is the batch-reveal callable of
``core.engine.build_batch_executable``, cached per (batch key, row count,
fault modes, backend) with the reference's hit / miss / bucket-hit
counters and ``fresh`` flags, so the two packages' counters and traces
agree.  Nothing is traced or compiled: a miss builds the callable (and,
on the sim, its round index tensors on the device).

Dispatch is a *streaming pipeline* (:class:`StreamConfig`): up to
``depth`` batch slots are in flight at once.  ``execute_async`` packs a
slot into a pinned host buffer from the executor's pool, copies it up
with ``non_blocking=True`` and enqueues the engine's launches on the
current stream without waiting, so packing batch k+1 overlaps the device
aggregating batch k.  Each slot records an event after its upload (the
buffer returns to the pool once that event has completed) and brings its
result back into pinned host memory behind a second event; settling a
slot is that event's ``synchronize()`` (the next issue once the ring is
full, or ``flush()``).  ``depth=1`` reproduces the sequential dispatch
exactly.  On the mesh backend ``MeshTransport.execute`` blocks the host
on gloo, so a slot settles before the next is packed: the slot semantics
hold, with nothing to overlap.

Long payloads chunk across batch *rows*: a session whose payload
exceeds ``BatchingConfig.max_row_elems`` contributes several (n, T_row)
rows whose pad-stream counter offsets continue where the previous row
stopped, so the chunked session is bit-identical to a monolithic one.

Runtime faults are handled by the resilience layer: :meth:`execute`
retries a batch per its :class:`~repro_torch.runtime.resilience.
RetryPolicy`, then *bisects* a still-failing batch to quarantine the
poison session(s) into ``dead_letter``, and on the mesh a
:class:`~repro_torch.runtime.resilience.CircuitBreaker` falls back to the
sim after K consecutive mesh failures.  On the mesh every decision the
ranks could take apart is agreed over the group: each attempt's outcome
(ok / deadline exceeded / raised) is one ``all_reduce`` of a code before
the ladder branches, and the breaker's clock is rank 0's reading.

The admission queue coalesces sealed sessions per batch key and flushes
on a size and an age watermark, expires queued sessions past their
deadline and sheds the newest arrivals over ``max_pending_rows``
(weighted-fair across keys), as in the reference.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.engine import (MeshTransport, RoundIndex, SimTransport,
                                     build_batch_executable, execute_chunks)
from repro_torch.core.plan import (SessionMeta, compile_plan, fault_masks_of,
                                   _require)
from repro_torch.kernels.backend import resolve_device
from repro_torch.obs import metrics as M
from repro_torch.obs.trace import TraceRecorder, record_batch_trace
from repro_torch.runtime.chaos import (ChaosConfig, ChaosError, ChaosSchedule,
                                       ChaosTransport)
from repro_torch.runtime.resilience import (CircuitBreaker, DeadlineExceeded,
                                            RetryPolicy)
from repro_torch.service.session import (LifecycleError, Session,
                                         SessionState)

BatchKey = tuple

_MASK32 = 0xFFFFFFFF

# one-hot / count payloads pad to the kernel's 128-lane quantum rather
# than the coarse buckets (a 1025-bin histogram pads to 1152, not 4096)
FUNC_PAD_QUANTUM = 128


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    max_batch: int = 8            # size watermark, in batch ROWS (S)
    max_age: float = 0.05         # age watermark, in `now` units
    pad_buckets: tuple[int, ...] = (64, 256, 1024, 4096, 16384)
    # per-payload-length pads: {payload elems -> padded row elems},
    # consulted before the buckets (the tuner and the secure functions
    # write here); a plain mutable dict, as in the reference
    tuned: Optional[dict] = None
    # payloads longer than this chunk across multiple batch rows (the
    # per-session counter offsets keep chunked == monolithic); None
    # keeps one row, padded to a multiple of the top bucket
    max_row_elems: Optional[int] = None
    # load-shedding high-watermark: when the TOTAL pending rows across
    # all batch keys exceed this, newest-arrival sessions are shed
    # (EXPIRED, flush reason "shed") at submit time; None = unbounded
    max_pending_rows: Optional[int] = None
    # default session deadline: open() sets expires_at = now + ttl
    # unless the caller overrides it; None = sessions never expire
    session_ttl: Optional[float] = None

    def padded_elems(self, elems: int) -> int:
        if self.tuned is not None:
            hit = self.tuned.get(elems)
            if hit is not None:
                return hit
        for b in self.pad_buckets:
            if elems <= b:
                return b
        top = self.pad_buckets[-1]
        return ((elems + top - 1) // top) * top

    def register_func_elems(self, round_elems) -> None:
        """Install the secure-function pad rule (:func:`func_padded`)
        for every payload length a function plan will ship.  Requires a
        mutable ``tuned`` map; never overwrites an existing entry."""
        _require(self.tuned is not None,
                 "register_func_elems needs BatchingConfig(tuned={...}) "
                 "— a mutable per-elems pad map")
        for T in round_elems:
            self.tuned.setdefault(T, func_padded(T, self.pad_buckets))

    def row_layout(self, elems: int) -> tuple[int, int]:
        """(row_elems, n_rows) a payload of ``elems`` occupies."""
        if self.max_row_elems is not None and elems > self.max_row_elems:
            row = self.padded_elems(self.max_row_elems)
            return row, -(-elems // row)
        return self.padded_elems(elems), 1


def func_padded(elems: int, pad_buckets: tuple =
                BatchingConfig.pad_buckets) -> int:
    """The secure-function pad rule for one payload length: tiny count
    payloads (<= 8 elems) stay unpadded, wider one-hot rows round up to
    the 128-lane quantum, capped at what the buckets would pick."""
    if elems <= 8:
        return elems
    lane = -(-elems // FUNC_PAD_QUANTUM) * FUNC_PAD_QUANTUM
    for b in pad_buckets:
        if elems <= b:
            return min(lane, b)
    top = pad_buckets[-1]
    return min(lane, -(-elems // top) * top)


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Streaming-pipeline knobs of :class:`BatchedExecutor`.

    ``depth`` is the number of in-flight batch slots: 1 reproduces the
    fully-sequential dispatch; 2 double-buffers (pack slot k+1 while the
    device aggregates slot k).  ``donate`` has no meaning in torch (the
    reference donates the packed slot buffer to its jitted executable):
    the field and its validation are kept so configs carry across, and
    here the upload event decides when a pack buffer may be refilled.
    ``async_compile`` makes an executable-cache miss build the exact
    shape on a worker thread while the batch runs on an already-built
    larger-S shape bucket, padded with zero-contribution dummy rows —
    bit-identical for the real rows because batch rows are independent
    sessions."""

    depth: int = 2
    donate: Optional[bool] = None
    async_compile: bool = True

    def resolve_donate(self) -> bool:
        """The reference's donation switch, resolved without a backend
        to ask: ``None`` reads as False (nothing is donated here)."""
        if self.donate is None:
            return False
        return self.donate


class _Slot:
    """One in-flight streaming dispatch: the host result buffer and its
    event, plus everything the deferred completion (reveal / account /
    retry) needs."""

    __slots__ = ("sessions", "padded", "unit", "backend", "degraded",
                 "revealed", "done", "owner", "fresh", "rows", "masks",
                 "t_issue", "error")

    def __init__(self, sessions, padded, unit, backend, degraded):
        self.sessions = sessions
        self.padded = padded
        self.unit = unit
        self.backend = backend
        self.degraded = degraded
        self.revealed = None          # host tensor, valid once done is
        self.done = None              # the result copy's event (or None)
        self.owner = None
        self.fresh = False
        self.rows = 0
        self.masks = {}
        self.t_issue = 0.0
        self.error: Optional[Exception] = None


class _Agreement:
    """Group agreement of a mesh executor's ranks.

    Every rank runs its own copy of the service, so a decision driven by
    a clock or by a failure on one rank could split the group.  The
    agreement makes those decisions once: ``now`` hands every rank rank
    0's reading of a clock, and ``outcome`` reduces each attempt's
    outcome code (0 ok, 1 deadline exceeded, 2 raised) to the group's
    worst.  Both are collectives over the mesh's group: every rank calls
    them at the same points, which the service's agreed decisions keep
    true."""

    OK, DEADLINE, RAISED = 0, 1, 2

    def __init__(self, group):
        self.group = group

    def now(self, clock: Callable[[], float]) -> float:
        t = torch.tensor([clock()], dtype=torch.float64)
        dist.broadcast(t, src=0, group=self.group)
        return float(t[0])

    def outcome(self, code: int) -> int:
        t = torch.tensor([code], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return int(t[0])


def agreement_of(transport: str, mesh) -> Optional[_Agreement]:
    """The mesh executor's group agreement, or None: on the sim, or
    where no process group is started (a single process, nothing to
    agree with)."""
    if (transport != "mesh" or not dist.is_available()
            or not dist.is_initialized()):
        return None
    return _Agreement(getattr(mesh, "group", None))


class _AgreedClock:
    """A clock every rank of the group reads the same: rank 0's."""

    def __init__(self, clock: Callable[[], float], agree: _Agreement):
        self.clock = clock
        self.agree = agree

    def __call__(self) -> float:
        return self.agree.now(self.clock)


class BatchedExecutor:
    """Runs batches of sealed sessions through one engine execution.

    Batch executables are cached per (batch key, row count, fault modes,
    backend).  Failures go through the retry -> bisect -> quarantine
    ladder of ``retry``; a mesh executor additionally degrades to the sim
    transport behind ``breaker``.  ``device`` is where the batches run
    (``None``: the card); on a mesh, this rank's device."""

    def __init__(self, kernel_impl: Optional[str] = None,
                 transport: str = "sim", mesh=None,
                 dp_axes: Sequence[str] = ("data",),
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 chaos=None,
                 metrics: Optional[M.MetricsRegistry] = None,
                 recorder: Optional[TraceRecorder] = None,
                 stream: Optional[StreamConfig] = None, *,
                 device=None):
        _require(transport in ("sim", "mesh"),
                 f"unknown executor transport {transport!r}; pick 'sim' "
                 "(single-device oracle) or 'mesh' (one rank process per "
                 "protocol node)")
        _require(transport != "mesh" or mesh is not None,
                 "executor transport='mesh' needs a mesh: pass "
                 "mesh=compat.node_mesh(n_nodes) (one rank per protocol "
                 "node)")
        self.kernel_impl = kernel_impl
        self.transport = transport
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes)
        self.device = resolve_device(device)
        self.retry = retry if retry is not None else RetryPolicy()
        # the degrade ladder only applies to the distributed backend —
        # a sim executor has nothing to fall back to
        self.breaker = breaker if breaker is not None else (
            CircuitBreaker() if transport == "mesh" else None)
        self._agree = agreement_of(transport, mesh)
        if self._agree is not None and self.breaker is not None:
            # the cooloff is read on rank 0's clock, so every rank probes
            # the mesh on the same batch
            self.breaker.clock = _AgreedClock(self.breaker.clock,
                                              self._agree)
        if chaos is not None and isinstance(chaos, ChaosConfig):
            chaos = ChaosSchedule(chaos)
        self.chaos: Optional[ChaosSchedule] = chaos
        self.stream = stream if stream is not None else StreamConfig()
        self._donate = self.stream.resolve_donate()
        self._fns: dict = {}
        self._index: dict = {}        # params -> RoundIndex on the device
        # streaming pipeline state: in-flight slots (issued, not yet
        # settled), unit errors deferred to flush(), and the background
        # build pool (lazily made on the first bucketed miss)
        self._ring: collections.deque = collections.deque()
        self._errors: list[Exception] = []
        self._warming: dict = {}
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        # recycled pinned pack buffers, keyed by (rows, n, padded), and
        # the buffers whose upload may still be reading them, each behind
        # its upload event
        self._buf_pool: dict = {}
        self._in_upload: list = []
        self._pinned = self.device.type == "cuda"
        self.metrics = M.registry_or_default(metrics)
        self.recorder = recorder
        # stage spans use the recorder's clock when one is attached
        # (deterministic replays inject a TickClock); perf_counter
        # otherwise
        self._clock = (recorder.clock if recorder is not None
                       else time.perf_counter)
        m = self.metrics
        self._c_batches = m.counter(M.M_BATCHES)
        self._c_sessions = m.counter(M.M_SESSIONS)
        self._c_fn_hits = m.counter(M.M_FN_HITS)
        self._c_fn_misses = m.counter(M.M_FN_MISSES)
        self._c_fn_bucket = m.counter(M.M_FN_BUCKET_HITS)
        self._g_depth = m.gauge(M.G_PIPELINE_DEPTH)
        self._c_retries = m.counter(M.M_RETRIES)
        self._c_bisections = m.counter(M.M_BISECTIONS)
        self._c_quarantined = m.counter(M.M_QUARANTINED)
        self._c_deadline = m.counter(M.M_DEADLINE_HITS)
        self._c_degraded = m.counter(M.M_DEGRADED)
        self._c_wire = m.counter(M.M_WIRE_BYTES)
        self._h_stage = {s: m.histogram(M.H_STAGE, stage=s)
                         for s in M.STAGES}
        self.dead_letter: list[tuple[int, str]] = []   # (sid, error repr)
        self._units = 0               # retry units started (jitter salt)
        self._plans: dict = {}        # params -> AggPlan (byte account)

    def _plan_of(self, template: Session):
        """Compiled plan of one batch's shared params (hot-path memo in
        front of the module-wide ``compile_plan`` cache)."""
        plan = self._plans.get(template.params)
        if plan is None:
            plan = compile_plan(template.params.agg_config(self.kernel_impl))
            self._plans[template.params] = plan
        return plan

    def _index_of(self, template: Session) -> RoundIndex:
        """The sim's round index tensors for one batch's params, built on
        the executor's device once."""
        idx = self._index.get(template.params)
        if idx is None:
            idx = RoundIndex(self._plan_of(template), self.device)
            self._index[template.params] = idx
        return idx

    # -- registry-backed counter views ---------------------------------
    @property
    def batches_run(self) -> int:
        return self._c_batches.value

    @property
    def sessions_run(self) -> int:
        return self._c_sessions.value

    @property
    def fn_cache_hits(self) -> int:
        return self._c_fn_hits.value

    @property
    def fn_cache_misses(self) -> int:
        return self._c_fn_misses.value

    @property
    def retries(self) -> int:
        return self._c_retries.value

    @property
    def bisections(self) -> int:
        return self._c_bisections.value

    @property
    def quarantined(self) -> int:
        return self._c_quarantined.value

    @property
    def deadline_hits(self) -> int:
        return self._c_deadline.value

    @property
    def degraded_batches(self) -> int:
        return self._c_degraded.value

    @property
    def wire_bytes(self) -> int:
        """Cumulative wire bytes of every executed batch —
        ``AggPlan.wire_bytes`` at the executed row count, which is what
        the engine's ``Transport.bytes_sent`` counted for them."""
        return self._c_wire.value

    @property
    def cache_stats(self) -> dict:
        """Batch-executable cache account (plan compilation has its own
        shared memo — see ``core.plan.plan_cache_stats``)."""
        return {"hits": self.fn_cache_hits, "misses": self.fn_cache_misses,
                "bucket_hits": self._c_fn_bucket.value,
                "size": len(self._fns)}

    @property
    def resilience(self) -> dict:
        """Retry/quarantine/degrade account (see module docstring)."""
        return {
            "retries": self.retries,
            "bisections": self.bisections,
            "quarantined": self.quarantined,
            "deadline_hits": self.deadline_hits,
            "degraded_batches": self.degraded_batches,
            "dead_letter": tuple(self.dead_letter),
            "chaos_injected": (self.chaos.injected
                               if self.chaos is not None else 0),
            "breaker": (self.breaker.snapshot()
                        if self.breaker is not None else None),
        }

    def _build_fn(self, template: Session, backend: str):
        """The batch-reveal callable (``core.engine.
        build_batch_executable``) of one batch's plan on ``backend``."""
        plan = self._plan_of(template)
        if backend == "mesh":
            return build_batch_executable(
                plan, backend="mesh", mesh=self.mesh, dp_axes=self.dp_axes,
                impl=self.kernel_impl)
        return build_batch_executable(plan, impl=self.kernel_impl,
                                      device=self.device,
                                      index=self._index_of(template))

    def _drain_warmed(self) -> None:
        """Promote finished background builds into the cache (a failed
        one is dropped — the next exact-shape miss builds synchronously
        and surfaces the error on the dispatch path)."""
        if not self._warming:
            return
        for key in [k for k, f in self._warming.items() if f.done()]:
            fut = self._warming.pop(key)
            try:
                self._fns[key] = fut.result()
            except Exception:
                pass

    def _warm_async(self, key, template: Session, backend: str) -> None:
        """Build the exact shape's executable on the worker thread while
        the pump keeps flowing on the bucket executable."""
        if key in self._warming:
            return
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)
        if backend == "sim":
            self._index_of(template)  # device tensors: built here, once
        self._warming[key] = self._pool.submit(self._build_fn, template,
                                               backend)

    def _compiled(self, template: Session, padded: int, S: int,
                  modes: frozenset,
                  backend: str) -> tuple[Callable, bool, int]:
        """(executable, fresh, S_exec) — ``fresh`` marks a synchronous
        cache miss, which the stage timer attributes to ``plan_compile``.
        ``S_exec >= S`` is the row count the returned executable is
        cached for: on a miss with ``async_compile`` the exact shape
        builds in the background and the dispatch runs on the smallest
        already-built larger-S bucket (the caller pads with dummy rows
        and slices the first S back out)."""
        # fault PATTERNS are runtime (S, n) masks; only the set of fault
        # MODES present and the dispatch backend are part of the
        # executable's identity
        bk = template.params.batch_key(padded)
        key = (bk, S, modes, backend)
        self._drain_warmed()
        fn = self._fns.get(key)
        if fn is not None:
            self._c_fn_hits.inc()
            return fn, False, S
        self._c_fn_misses.inc()
        if self.stream.async_compile and self.stream.depth > 1:
            buckets = [k[1] for k in self._fns
                       if k[0] == bk and k[2] == modes and k[3] == backend
                       and k[1] > S]
            if buckets:
                self._c_fn_bucket.inc()
                self._warm_async(key, template, backend)
                S_exec = min(buckets)
                return (self._fns[(bk, S_exec, modes, backend)],
                        False, S_exec)
        fn = self._build_fn(template, backend)
        self._fns[key] = fn
        return fn, True, S

    # -- host buffers --------------------------------------------------------
    def _host(self, shape, dtype) -> torch.Tensor:
        """An uninitialised host tensor: pinned when the batches run on
        the card (so its copies are asynchronous)."""
        return torch.empty(shape, dtype=dtype, pin_memory=self._pinned)

    def _buf_take(self, shape) -> torch.Tensor:
        """A pooled float32 pack buffer (fresh if the pool is dry)."""
        self._reclaim()
        pool = self._buf_pool.get(shape)
        if pool:
            return pool.pop()
        return self._host(shape, torch.float32)

    def _buf_give(self, buf, uploaded=None) -> None:
        """Hand a pack buffer back: at once when nothing reads it any
        more, else once ``uploaded`` (its upload's event) has completed.
        The pool is capped per shape (depth + a retry's worth of
        slack); overflow buffers drop to the allocator."""
        if buf is None:
            return
        if uploaded is not None and not uploaded.query():
            self._in_upload.append((uploaded, buf))
            return
        pool = self._buf_pool.setdefault(tuple(buf.shape), [])
        if len(pool) < max(self.stream.depth, 1) + 2:
            pool.append(buf)

    def _reclaim(self) -> None:
        """Return the buffers whose uploads have completed."""
        if not self._in_upload:
            return
        waiting = self._in_upload
        self._in_upload = []
        for ev, buf in waiting:
            self._buf_give(buf, ev)

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cpu":
            return host
        return host.to(self.device, non_blocking=True)

    # -- one dispatch attempt ----------------------------------------------
    def _dispatch(self, sessions: Sequence[Session], padded: int,
                  backend: str, fault: Optional[ChaosConfig]):
        """Pack + issue one batch WITHOUT the host sync: returns
        ``(revealed, done, owner, fresh, rows, masks)`` where
        ``revealed`` is the host tensor the result of the first ``rows``
        real rows lands in once ``done`` (an event, or None where it is
        already there) has completed, and ``masks`` are the real rows'
        fault masks (what the trace records).  Session state is
        untouched, so a failed attempt stays retriable."""
        if fault is not None and fault.mode == "dispatch":
            raise ChaosError(
                f"chaos: injected dispatch failure "
                f"(batch of {len(sessions)})")
        if fault is not None and fault.mode == "slow":
            time.sleep(fault.slow_s)
        n_nodes = sessions[0].params.n_nodes
        seeds, offsets, owner = [], [], []
        for i, s in enumerate(sessions):
            for j in range(s.n_rows(padded)):
                seeds.append(s.seed)
                offsets.append((s.pad_offset + j * padded) & _MASK32)
                owner.append(i)
        R = len(owner)
        owner = np.asarray(owner)
        sess_masks = fault_masks_of(
            [s.fault.specs() for s in sessions], n_nodes)
        masks = {m: v[owner] for m, v in sess_masks.items()}  # per row
        if fault is not None and fault.mode == "compile":
            raise ChaosError("chaos: injected compile failure")
        if fault is not None and fault.mode == "hop":
            fresh = False                  # outside the executable cache
            xs = self._host((R, n_nodes, padded), torch.float32)
            r = 0
            for s in sessions:
                r += s.fill_payload_rows(xs.numpy(), r, padded)
            out = self._chaos_hop_run(sessions[0], xs, seeds, offsets,
                                      masks, backend, fault)
            revealed, done = self._download(out)
            return revealed, done, owner, fresh, R, masks
        fn, fresh, S_exec = self._compiled(sessions[0], padded, R,
                                           frozenset(masks), backend)
        # pack straight into a recycled (S_exec, n, padded) pinned buffer
        # — fill_payload_rows writes every byte of the real rows, so no
        # pre-zeroing; the buffer returns to the pool once its upload
        # has completed
        xs = self._buf_take((S_exec, n_nodes, padded))
        xs_np = xs.numpy()
        r = 0
        for s in sessions:
            r += s.fill_payload_rows(xs_np, r, padded)
        dm = masks
        if S_exec > R:
            # shape-bucket dispatch: dummy zero rows (zero payload, zero
            # seed/offset, no faults) — batch rows are independent
            # sessions, so the real rows' outputs are bit-identical and
            # the dummies are sliced off after the sync
            pad = S_exec - R
            xs_np[R:] = 0.0
            seeds = list(seeds) + [0] * pad
            offsets = list(offsets) + [0] * pad
            dm = {m: np.concatenate(
                [v, np.zeros((pad, n_nodes), v.dtype)])
                for m, v in masks.items()}
        xs_dev, seeds_dev, offs_dev, masks_dev = self._upload(
            xs, seeds, offsets, dm)
        uploaded = self._event()
        out = fn(xs_dev, seeds_dev, offs_dev, masks_dev)
        self._buf_give(xs, uploaded)
        revealed, done = self._download(out)
        return revealed, done, owner, fresh, R, masks

    def _event(self):
        """An event recorded on the current stream (None on the CPU,
        where every copy is done when it returns)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _words(self, vals) -> torch.Tensor:
        """uint32 values (Python ints) -> int32 words, on the host."""
        a = (np.asarray(vals, dtype=np.int64) & _MASK32).astype(np.uint32)
        h = self._host((len(a),), torch.int32)
        h.numpy()[:] = a.view(np.int32)
        return h

    def _upload(self, xs, seeds, offsets, masks) -> tuple:
        """The packed batch, its seeds / offsets (int32 words) and fault
        masks on the device, each copied without blocking the host."""
        mh = {}
        for k, v in masks.items():
            h = self._host(v.shape, torch.bool)
            h.numpy()[:] = v
            mh[k] = h
        return (self._to_device(xs), self._to_device(self._words(seeds)),
                self._to_device(self._words(offsets)),
                {k: self._to_device(h) for k, h in mh.items()})

    def _download(self, out: torch.Tensor) -> tuple:
        """(host tensor the result lands in, its copy's event)."""
        if out.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        return host, self._event()

    def _account(self, sessions: Sequence[Session], padded: int, rows: int,
                 masks: dict, unit: int, attempt: int, backend: str,
                 fresh: bool) -> None:
        """Book one completed attempt's wire bytes and flight-recorder
        events — host-side, after the device sync."""
        plan = self._plan_of(sessions[0])
        self._c_wire.inc(plan.wire_bytes(padded, S=rows))
        if self.recorder is not None:
            record_batch_trace(
                self.recorder, plan, padded=padded, rows=rows,
                masks=masks, unit=unit, attempt=attempt, backend=backend,
                sids=tuple(s.sid for s in sessions), fresh=fresh)

    def _attempt(self, sessions: Sequence[Session], padded: int,
                 backend: str, fault: Optional[ChaosConfig],
                 unit: int = 0, attempt: int = 1):
        """One SYNCHRONOUS dispatch: pack, execute, block, account.
        Returns (revealed, owner) without touching session state (the
        caller reveals after the deadline check, so a failed/too-slow
        attempt stays retriable)."""
        t0 = self._clock()
        revealed, done, owner, fresh, R, masks = self._dispatch(
            sessions, padded, backend, fault)
        if done is not None:
            done.synchronize()                  # host sync: span ends here
        revealed = revealed[:R]
        stage = "plan_compile" if fresh else "device_dispatch"
        self._h_stage[stage].observe(self._clock() - t0)
        self._account(sessions, padded, R, masks, unit, attempt, backend,
                      fresh)
        return revealed, owner

    def _chaos_hop_run(self, template: Session, xs, seeds, offsets, masks,
                       backend: str, fault: ChaosConfig):
        """Engine run with a ChaosTransport wrapped around the substrate,
        outside the executable cache, so a raise-at-hop-k fault fires on
        every armed attempt."""
        plan = self._plan_of(template)
        seeds_h, offs_h = self._words(seeds), self._words(offsets)
        meta = SessionMeta(
            seeds=self._to_device(seeds_h),
            offsets=self._to_device(offs_h),
            fault_masks={k: self._to_device(torch.from_numpy(v))
                         for k, v in masks.items()})
        xd = self._to_device(xs)
        if backend == "mesh":
            mt = MeshTransport(self.mesh, self.dp_axes,
                               impl=self.kernel_impl,
                               wrap_inner=lambda tp: ChaosTransport(
                                   tp, fault))
            return mt.execute(plan, xd, meta, reveal_only=True)
        R, n, T = xd.shape
        tp = ChaosTransport(SimTransport(plan, S=R, impl=self.kernel_impl,
                                         device=self.device,
                                         index=self._index_of(template)),
                            fault)
        flat = xd.reshape(R * n, T)
        (out,) = execute_chunks(plan, tp, [flat], meta, reveal_only=True)
        return out

    # -- group agreement ------------------------------------------------------
    def _agreed(self, err: Optional[Exception], deadline: bool
                ) -> Optional[Exception]:
        """The attempt's error as the group sees it.  Off the mesh: the
        local one (a deadline counted and raised as in the reference).
        On the mesh: the worst outcome over the ranks, so every rank's
        ladder takes the same branch."""
        code = (_Agreement.RAISED if err is not None
                else _Agreement.DEADLINE if deadline else _Agreement.OK)
        if self._agree is not None:
            code = self._agree.outcome(code)
        if code == _Agreement.OK:
            return None
        if code == _Agreement.DEADLINE:
            self._c_deadline.inc()
            return DeadlineExceeded(
                f"batch attempt exceeded the "
                f"{self.retry.deadline_s}s deadline")
        if err is None:
            err = RuntimeError("batch attempt failed on another rank of "
                               "the mesh")
        return err

    # -- retry / bisect / quarantine ladder ---------------------------------
    def _run_unit(self, sessions: list[Session], padded: int,
                  start_attempt: int = 1,
                  prior_error: Optional[Exception] = None,
                  salt: Optional[int] = None) -> Optional[Exception]:
        """Drive one retry unit to a terminal state: every session ends
        REVEALED or FAILED (never AGGREGATING).  Returns the first
        triggering error if any session was quarantined, else None.

        The streaming path re-enters here after a slot's non-blocking
        attempt 1 already failed at settlement: ``start_attempt=2``
        continues the SAME unit (``salt`` keeps the backoff jitter and
        trace unit id stable) with ``prior_error`` standing in as the
        last error if the remaining budget is empty."""
        policy = self.retry
        if salt is None:
            self._units += 1
            salt = self._units
        rec = self.recorder
        sids = tuple(s.sid for s in sessions)
        last: Optional[Exception] = prior_error
        for attempt in range(start_attempt, policy.max_attempts + 1):
            backend = self.transport
            degraded = False
            if (self.breaker is not None and backend == "mesh"
                    and not self.breaker.allow_primary()):
                backend, degraded = "sim", True
            fault = (self.chaos.decide(sessions, backend)
                     if self.chaos is not None else None)
            if fault is not None and rec is not None:
                rec.event("chaos", unit=salt, attempt=attempt,
                          mode=fault.mode, backend=backend,
                          sids=list(sids))
            t0 = time.monotonic()
            err, late = None, False
            try:
                revealed, owner = self._attempt(sessions, padded,
                                                backend, fault,
                                                unit=salt, attempt=attempt)
                late = (policy.deadline_s is not None
                        and time.monotonic() - t0 > policy.deadline_s)
            except Exception as e:
                err = e
            err = self._agreed(err, late)
            if err is not None:
                last = err
                self._record_breaker(rec, backend, failed=True)
                if attempt < policy.max_attempts:
                    self._c_retries.inc()
                    delay = policy.backoff_s(attempt, salt=salt)
                    if rec is not None:
                        rec.event("retry", unit=salt, attempt=attempt,
                                  backend=backend, delay=delay,
                                  error=repr(err)[:200])
                    if delay > 0:
                        policy.sleep(delay)
                continue
            self._record_breaker(rec, backend, failed=False)
            if degraded:
                self._c_degraded.inc()
                if rec is not None:
                    rec.event("degrade", unit=salt, attempt=attempt,
                              sids=list(sids))
            t1 = self._clock()
            self._reveal(sessions, revealed, owner)
            self._h_stage["reveal"].observe(self._clock() - t1)
            self._c_batches.inc()
            self._c_sessions.inc(len(sessions))
            return None
        # attempt budget exhausted: bisect to isolate the poison rows
        if policy.bisect and len(sessions) > 1:
            self._c_bisections.inc()
            mid = len(sessions) // 2
            if rec is not None:
                rec.event("bisect", unit=salt,
                          left=[s.sid for s in sessions[:mid]],
                          right=[s.sid for s in sessions[mid:]])
            e1 = self._run_unit(sessions[:mid], padded)
            e2 = self._run_unit(sessions[mid:], padded)
            return e1 if e1 is not None else e2
        # irreducible unit still failing: quarantine it
        for s in sessions:
            s.fail(repr(last))
            self.dead_letter.append((s.sid, repr(last)))
        self._c_quarantined.inc(len(sessions))
        if rec is not None:
            rec.event("quarantine", unit=salt, sids=list(sids),
                      error=repr(last)[:200])
        if len(self.dead_letter) > 4096:          # bounded history
            del self.dead_letter[:-2048]
        return last

    @staticmethod
    def _reveal(sessions: Sequence[Session], revealed: torch.Tensor,
                owner: np.ndarray) -> None:
        """Hand each session its rows of the host result (a session
        spanning several rows gets them concatenated)."""
        start = 0
        for i, s in enumerate(sessions):
            k = int((owner == i).sum())
            s.reveal(revealed[start:start + k].reshape(-1))
            start += k

    def _record_breaker(self, rec, backend: str, *, failed: bool) -> None:
        """Feed the breaker and trace its state transitions."""
        if self.breaker is None or backend != "mesh":
            return
        before = self.breaker.state
        if failed:
            self.breaker.record_failure()
        else:
            self.breaker.record_success()
        if rec is not None and self.breaker.state != before:
            rec.event("breaker", state=self.breaker.state)

    def execute(self, sessions: Sequence[Session],
                padded_elems: Optional[int] = None) -> None:
        """Aggregate + reveal one batch (all sessions share a batch key).

        A session may span several batch rows (long payloads); row j of
        a session reuses its pad key at counter offset ``pad_offset +
        j * padded_elems``.  Failures run the retry -> bisect ->
        quarantine ladder: surviving sessions reveal normally and the
        poison ones land in :attr:`dead_letter` as FAILED.  The first
        triggering error re-raises only when NO session in the call
        survived."""
        if not sessions:
            return
        padded = padded_elems or max(s.params.elems for s in sessions)
        key0 = sessions[0].params.batch_key(padded)
        _require(all(s.params.batch_key(padded) == key0 for s in sessions),
                 "batch mixes incompatible sessions (distinct batch "
                 "keys); group sessions per AdmissionQueue.submit key")
        sessions = list(sessions)
        for s in sessions:
            s.mark_aggregating()
        self._g_depth.track_max(1.0)
        try:
            err = self._run_unit(sessions, padded)
        except BaseException:
            # unexpected escape (bug / KeyboardInterrupt): never leave a
            # session wedged in AGGREGATING
            for s in sessions:
                if s.state is SessionState.AGGREGATING:
                    s.fail("executor aborted mid-batch")
            raise
        if err is not None and all(s.state is SessionState.FAILED
                                   for s in sessions):
            raise err

    # -- streaming pipeline (overlapped dispatch) ---------------------------
    def execute_async(self, sessions: Sequence[Session],
                      padded_elems: Optional[int] = None) -> None:
        """Issue one batch into the streaming ring without blocking on
        its device result.

        Same batch-key/lifecycle contract as :meth:`execute`, but the
        dispatch is only *issued* here (the pack, the non-blocking
        upload and the engine's launches, timed as the ``pack_overlap``
        stage); the host sync, the reveal, and the retry ladder run when
        the slot is settled — at the next issue once the ring holds
        ``StreamConfig.depth`` slots, or at :meth:`flush`.  Unit failures
        NEVER raise here: a failed slot re-enters the retry -> bisect ->
        quarantine ladder at settlement, and an all-failed unit's error
        is deferred to the next :meth:`flush`."""
        if not sessions:
            return
        padded = padded_elems or max(s.params.elems for s in sessions)
        key0 = sessions[0].params.batch_key(padded)
        _require(all(s.params.batch_key(padded) == key0 for s in sessions),
                 "batch mixes incompatible sessions (distinct batch "
                 "keys); group sessions per AdmissionQueue.submit key")
        sessions = list(sessions)
        for s in sessions:
            s.mark_aggregating()
        try:
            while len(self._ring) >= max(self.stream.depth, 1):
                self._flush_one()
        except BaseException:
            self._abort_ring()
            for s in sessions:
                if s.state is SessionState.AGGREGATING:
                    s.fail("executor aborted mid-batch")
            raise
        self._ring.append(self._issue(sessions, padded))
        self._g_depth.track_max(float(len(self._ring)))

    def flush(self) -> None:
        """Settle every in-flight streaming slot (reveal / retry /
        quarantine), then re-raise the FIRST deferred all-failed unit
        error."""
        try:
            while self._ring:
                self._flush_one()
        except BaseException:
            self._abort_ring()
            raise
        if self._errors:
            err = self._errors[0]
            self._errors.clear()
            raise err

    def _abort_ring(self) -> None:
        """Unexpected escape mid-drain: never leave ring sessions
        wedged in AGGREGATING."""
        while self._ring:
            slot = self._ring.popleft()
            for s in slot.sessions:
                if s.state is SessionState.AGGREGATING:
                    s.fail("executor aborted mid-batch")

    def _issue(self, sessions: list, padded: int) -> _Slot:
        """Attempt 1 of a new retry unit, issued without blocking: the
        breaker/chaos decisions and the host-side pack + launches run
        now (the ``pack_overlap`` span — overlapped with the previous
        slot's device work), exceptions are captured on the slot."""
        self._units += 1
        salt = self._units
        backend = self.transport
        degraded = False
        if (self.breaker is not None and backend == "mesh"
                and not self.breaker.allow_primary()):
            backend, degraded = "sim", True
        fault = (self.chaos.decide(sessions, backend)
                 if self.chaos is not None else None)
        rec = self.recorder
        if fault is not None and rec is not None:
            rec.event("chaos", unit=salt, attempt=1, mode=fault.mode,
                      backend=backend, sids=[s.sid for s in sessions])
        slot = _Slot(sessions, padded, salt, backend, degraded)
        slot.t_issue = time.monotonic()
        t0 = self._clock()
        try:
            (slot.revealed, slot.done, slot.owner, slot.fresh, slot.rows,
             slot.masks) = self._dispatch(sessions, padded, backend, fault)
        except Exception as e:
            slot.error = e
        self._h_stage["pack_overlap"].observe(self._clock() - t0)
        return slot

    def _settle(self, slot: _Slot) -> Optional[Exception]:
        """Complete one issued slot: host sync (the streaming
        ``device_dispatch`` span is just this blocking wait), deadline
        check, account, breaker feed, reveal.  Returns the attempt's
        error instead of raising (the caller owns the drain-then-retry
        ordering); session state is only touched on success."""
        policy = self.retry
        rec = self.recorder
        err, late = slot.error, False
        if err is None:
            try:
                t0 = self._clock()
                if slot.done is not None:
                    slot.done.synchronize()                  # host sync
                revealed = slot.revealed[:slot.rows]
                stage = "plan_compile" if slot.fresh else "device_dispatch"
                self._h_stage[stage].observe(self._clock() - t0)
                late = (policy.deadline_s is not None
                        and time.monotonic() - slot.t_issue
                        > policy.deadline_s)
            except Exception as e:
                err = e
        err = self._agreed(err, late)
        if err is not None:
            self._record_breaker(rec, slot.backend, failed=True)
            return err
        self._account(slot.sessions, slot.padded, slot.rows, slot.masks,
                      slot.unit, 1, slot.backend, slot.fresh)
        self._record_breaker(rec, slot.backend, failed=False)
        if slot.degraded:
            self._c_degraded.inc()
            if rec is not None:
                rec.event("degrade", unit=slot.unit, attempt=1,
                          sids=[s.sid for s in slot.sessions])
        t1 = self._clock()
        self._reveal(slot.sessions, revealed, slot.owner)
        self._h_stage["reveal"].observe(self._clock() - t1)
        self._c_batches.inc()
        self._c_sessions.inc(len(slot.sessions))
        return None

    def _retry_continuation(self, slot: _Slot,
                            e: Exception) -> Optional[Exception]:
        """Re-enter the retry ladder for a slot whose non-blocking
        attempt 1 failed: book the retry (same unit id, same jitter
        salt as a sequential attempt-1 failure would), then continue
        the unit synchronously from attempt 2."""
        policy = self.retry
        rec = self.recorder
        if policy.max_attempts > 1:
            self._c_retries.inc()
            delay = policy.backoff_s(1, salt=slot.unit)
            if rec is not None:
                rec.event("retry", unit=slot.unit, attempt=1,
                          backend=slot.backend, delay=delay,
                          error=repr(e)[:200])
            if delay > 0:
                policy.sleep(delay)
        return self._run_unit(slot.sessions, slot.padded,
                              start_attempt=2, prior_error=e,
                              salt=slot.unit)

    def _flush_one(self) -> None:
        """Settle the oldest in-flight slot.  On failure, FIRST drain
        every other in-flight slot (the retry/bisect ladder re-dispatches
        synchronously), then run the failed slots' retry continuations
        in issue order."""
        pending = [self._ring.popleft()]
        try:
            err = self._settle(pending[0])
            if err is None:
                return
            failures = [(pending[0], err)]
            while self._ring:        # drain in-flight before re-dispatch
                nxt = self._ring.popleft()
                pending.append(nxt)
                e2 = self._settle(nxt)
                if e2 is None:
                    pending.remove(nxt)
                else:
                    failures.append((nxt, e2))
            for sl, e in failures:
                unit_err = self._retry_continuation(sl, e)
                pending.remove(sl)
                if unit_err is not None and all(
                        s.state is SessionState.FAILED
                        for s in sl.sessions):
                    self._errors.append(unit_err)
        except BaseException:
            for sl in pending:
                for s in sl.sessions:
                    if s.state is SessionState.AGGREGATING:
                        s.fail("executor aborted mid-batch")
            raise


class AdmissionQueue:
    """Coalesces sealed sessions into fixed-size batches per batch key.

    ``clock`` is what ``pump(now=None)`` and ``oldest_ages(now=None)``
    read (the service hands a mesh executor's queue the group-agreed
    clock)."""

    def __init__(self, executor: BatchedExecutor,
                 batching: BatchingConfig = BatchingConfig(),
                 pre_execute: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.executor = executor
        self.batching = batching
        self.pre_execute = pre_execute   # e.g. epoch-departure fault merge
        self.clock = clock
        self._pending: dict[BatchKey, list[Session]] = {}
        self.batch_sizes: list[int] = []
        reg = executor.metrics
        self.recorder = executor.recorder
        self._c_flush = {r: reg.counter(M.M_FLUSHES, reason=r)
                         for r in ("size", "age", "force", "shed")}
        self._g_max_age = reg.gauge(M.M_MAX_QUEUE_AGE)
        self._c_starved = reg.counter(M.M_STARVED)
        self._c_expired = reg.counter(M.M_EXPIRED)
        self._c_shed = reg.counter(M.M_SHED)
        self._c_dropped = reg.counter(M.M_DROPPED)
        self._h_wait = executor._h_stage["admission_wait"]

    # -- registry-backed counter views ---------------------------------
    @property
    def flush_reasons(self) -> dict:
        return {r: c.value for r, c in self._c_flush.items()}

    @property
    def max_queue_age(self) -> float:
        return self._g_max_age.value

    @property
    def starved_sessions(self) -> int:
        return self._c_starved.value    # flushed only after 2x the age mark

    @property
    def expired_sessions(self) -> int:
        return self._c_expired.value    # deadline reached while queued

    @property
    def shed_sessions(self) -> int:
        return self._c_shed.value       # dropped by the load watermark

    @property
    def dropped_sessions(self) -> int:
        return self._c_dropped.value    # left the queue already terminal

    def submit(self, session: Session,
               now: Optional[float] = None) -> BatchKey:
        if session.state is not SessionState.SEALED:
            raise LifecycleError(
                f"only SEALED sessions enter the admission queue, got "
                f"{session!r}")
        row_elems, _ = self.batching.row_layout(session.params.elems)
        key = session.params.batch_key(row_elems)
        self._pending.setdefault(key, []).append(session)
        if self.batching.max_pending_rows is not None:
            self._shed(session.sealed_at if now is None else now)
        return key

    def depth(self) -> int:
        return sum(len(q) for q in self._pending.values())

    def depth_rows(self) -> int:
        """Total pending batch rows across all keys (the unit the
        ``max_pending_rows`` load watermark is measured in)."""
        return sum(self._rows(key, q) for key, q in self._pending.items())

    def oldest_ages(self, now: Optional[float] = None) -> dict:
        """Per-key age watermark: how long each key's oldest sealed
        session has been waiting."""
        now = self.clock() if now is None else now
        return {key: now - min(s.sealed_at for s in q)
                for key, q in self._pending.items() if q}

    @property
    def metrics(self) -> dict:
        return {
            "flush_reasons": dict(self.flush_reasons),
            "max_queue_age": self.max_queue_age,
            "starved_sessions": self.starved_sessions,
            "expired_sessions": self.expired_sessions,
            "shed_sessions": self.shed_sessions,
            "dropped_sessions": self.dropped_sessions,
            "pending_sessions": self.depth(),
            "pending_rows": self.depth_rows(),
        }

    def _rows(self, key: BatchKey, sessions: Sequence[Session]) -> int:
        row_elems = key[-1]
        return sum(s.n_rows(row_elems) for s in sessions)

    def _shed(self, now: float) -> None:
        """Load shedding: while total pending rows exceed the
        high-watermark, drop the NEWEST arrival of the heaviest key —
        each key weighs ``pending_rows / (1 + oldest_age)``, so a young
        flood sheds before an old starving key loses anything."""
        limit = self.batching.max_pending_rows
        while self.depth_rows() > limit:
            ages = self.oldest_ages(now)
            key = max(self._pending,
                      key=lambda k: self._rows(k, self._pending[k])
                      / (1.0 + max(ages.get(k, 0.0), 0.0)))
            victim = self._pending[key].pop()     # newest arrival
            victim.expire(
                f"shed: admission queue over max_pending_rows={limit}")
            self._c_flush["shed"].inc()
            self._c_shed.inc()
            if self.recorder is not None:
                self.recorder.event("shed", sid=victim.sid,
                                    pending_rows=self.depth_rows(),
                                    limit=limit)
            if not self._pending[key]:
                del self._pending[key]

    def _sweep(self, q: list[Session], now: float) -> list[Session]:
        """Deadline/terminal sweep of one key's queue: expired sessions
        move to EXPIRED, sessions already terminal are dropped;
        survivors stay queued."""
        alive = []
        for s in q:
            if s.state is not SessionState.SEALED:
                self._c_dropped.inc()
            elif s.expired(now):
                s.expire("deadline: session expired before aggregation")
                self._c_expired.inc()
                if self.recorder is not None:
                    self.recorder.event("expire", sid=s.sid)
            else:
                alive.append(s)
        return alive

    def _run(self, key: BatchKey, batch: list[Session], reason: str,
             now: float, account_age: bool = True) -> None:
        if account_age:
            age = now - min(s.sealed_at for s in batch)
            self._g_max_age.track_max(age)
            self._c_starved.inc(sum(
                now - s.sealed_at >= 2 * self.batching.max_age
                for s in batch))
            # the admission-wait span of this batch (oldest member's
            # queue residency, on the open/seal/pump clock)
            self._h_wait.observe(age)
        self._c_flush[reason].inc()
        if self.recorder is not None:
            self.recorder.event("flush", reason=reason,
                                sids=[s.sid for s in batch],
                                rows=self._rows(key, batch))
        if self.pre_execute is not None:
            self.pre_execute(batch)
        if self.executor.stream.depth > 1:
            # streaming: issue without blocking; pump() drains the ring
            # (and re-raises deferred unit errors) after its key sweep
            self.executor.execute_async(batch, padded_elems=key[-1])
        else:
            self.executor.execute(batch, padded_elems=key[-1])
        self.batch_sizes.append(len(batch))
        if len(self.batch_sizes) > 4096:   # bounded history
            del self.batch_sizes[:-2048]

    def pump(self, now: Optional[float] = None, force: bool = False) -> int:
        """Flush ready batches; returns the number of sessions executed
        (revealed or quarantined — expired/shed sessions don't count).

        Size watermark: every group of ``max_batch`` ready rows flushes.
        Age watermark: a partial group flushes when its oldest member
        sealed more than ``max_age`` ago (or unconditionally with
        ``force``).  ``now`` defaults to the queue's clock.  A forced
        pump skips ALL age accounting.

        Keys are isolated: a key whose batch raises out of the executor
        is skipped for the rest of this pump, the sweep continues over
        the other keys, and the FIRST such error re-raises after the
        sweep completes."""
        now = self.clock() if now is None else now
        account_age = not force
        ran = 0
        first_err: Optional[Exception] = None
        for key in list(self._pending):
            q = self._pending[key]
            q[:] = self._sweep(q, now)
            try:
                while self._rows(key, q) >= self.batching.max_batch:
                    # FIFO prefix that fits the row budget — never exceeds
                    # max_batch rows, except a single session wider than
                    # the budget, which flushes alone
                    take, rows = [], 0
                    row_elems = key[-1]
                    while q and rows + q[0].n_rows(row_elems) \
                            <= self.batching.max_batch:
                        s = q.pop(0)
                        take.append(s)
                        rows += s.n_rows(row_elems)
                    if not take:
                        take.append(q.pop(0))
                    self._run(key, take, "size", now,
                              account_age=account_age)
                    ran += len(take)
                if q and (force or
                          now - min(s.sealed_at for s in q)
                          >= self.batching.max_age):
                    batch, self._pending[key] = list(q), []
                    q = self._pending[key]
                    # batch already dequeued: a raising executor has
                    # already quarantined it (never re-enqueued)
                    self._run(key, batch, "force" if force else "age", now,
                              account_age=account_age)
                    ran += len(batch)
            except Exception as e:
                if first_err is None:
                    first_err = e
                q = self._pending.get(key, [])
            if not q:
                self._pending.pop(key, None)
        # drain the streaming ring: every issued batch settles (reveal /
        # retry / quarantine) before pump returns, so callers see only
        # terminal sessions after a pump
        try:
            self.executor.flush()
        except Exception as e:
            if first_err is None:
                first_err = e
        if first_err is not None:
            raise first_err
        return ran
