"""The front door of the port: :class:`SecureAggregator`.

Counterpart of ``repro/api.py``: :meth:`~SecureAggregator.allreduce`
aggregates per-node payloads (a tensor, or a dict / list / tuple of
tensors, each with leading axis ``n_nodes``),
:meth:`~SecureAggregator.allreduce_batched` runs S independent sessions
in one pass, :meth:`~SecureAggregator.open_session` opens one query of
the multi-session service (``seal`` / ``pump`` / ``drain`` / ``result``
delegate to it), and :meth:`~SecureAggregator.cost` is the analytic wire
account, equal to the engine's executed bytes.  The secure-function
verbs (``histogram`` / ``quantile`` / ``median`` / ``minimum`` /
``maximum`` / ``topk``, from ``repro_torch.funcs``) compile non-additive
aggregations into static sequences of allreduces over {0, 1} payloads;
``open_session(fn=...)`` runs the same plans as multi-round service
sessions and ``cost(fn=...)`` sums their exact per-round account.
``tune=`` turns on the self-tuning planner (``repro_torch.tune``).
The facade caches one callable a payload shape, built on that shape's
plan, and counts the cache's hits and misses.  The ``Runtime`` section
picks the backend: the single-device oracle (``sim``), a process group
with one rank per node where every rank passes the global payloads
(``mesh``), or where each rank passes its own (``manual``, the training
step's path).

The facade runs on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises where there is none.  On the
card the three tensor stages launch the CUDA kernels;
``Runtime(kernel_impl="torch")`` asks for the plain versions instead.

    from repro_torch import SecureAggregator, Topology

    agg = SecureAggregator(topology=Topology(n_nodes=16))
    per_node = agg.allreduce(xs)          # xs: (16, T) payloads
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import engine as _engine
from repro_torch.core.plan import (AggConfig, AggPlan, ConfigError, Runtime,
                                   Security, SessionMeta, Topology, Wire,
                                   compile_func_plan, compile_plan,
                                   plan_cache_stats, words)
from repro_torch.core.schedules import schedule_cost
from repro_torch.kernels.backend import resolve_device
from repro_torch.obs import metrics as _obs
from repro_torch.obs.trace import record_batch_trace, record_func_round

__all__ = ["AggConfig", "ConfigError", "Runtime", "SecureAggregator",
           "Security", "SessionMeta", "Topology", "Wire", "compile_plan",
           "plan_cache_stats"]



def _structure(tree):
    """A hashable description of a payload tree's containers (the leaves
    stand in as ``None``): with the leaves' shapes, the key of the
    facade's per-shape callables."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return None


class SecureAggregator:
    """Facade over the plan / engine / transport core, constructed from
    the composable config model: pass a ready :class:`AggConfig` or the
    sections (``topology`` required, ``security`` / ``wire`` optional).
    ``runtime`` picks the backend and the kernel engine; ``device`` where
    the run lives (``None`` = the card; on a mesh, each rank's device).

    ``batching`` / ``epochs`` configure the session service behind
    :meth:`open_session`; ``retry`` / ``breaker`` / ``chaos`` its
    resilience layer (a ``RetryPolicy``, a ``CircuitBreaker`` for the
    mesh->sim degrade ladder, a ``ChaosConfig`` for deterministic fault
    injection); ``stream`` its pipeline (a ``StreamConfig``).
    ``metrics`` shares a :class:`~repro_torch.obs.MetricsRegistry`
    (default: a private one) and ``recorder`` attaches a
    :class:`~repro_torch.obs.TraceRecorder`; both reach the service.

    ``tune`` turns on the self-tuning planner (``repro_torch.tune``):
    ``"auto"`` (the exact cost oracle), ``"probe"`` (the oracle and one
    measured dispatch a finalist, on ``device``), or a ready
    :class:`~repro_torch.tune.Tuner`.  With tuning on, the schedule /
    transport / digest / chunk knobs and the service pad become hints:
    each verb resolves the workload signature ``(n_nodes, T, S, churn,
    byzantine budget)`` to the cheapest config by exact wire bytes,
    memoised per signature.  Policy knobs (masking, clip, seeds, the
    byzantine spec, the kernel engine) are never touched;
    ``stats()["tuner"]`` shows the decision and cache counters."""

    def __init__(self, cfg: Optional[AggConfig] = None, *,
                 topology: Optional[Topology] = None,
                 security: Optional[Security] = None,
                 wire: Optional[Wire] = None,
                 runtime: Optional[Runtime] = None,
                 batching=None, epochs=None, retry=None, breaker=None,
                 chaos=None, metrics=None, recorder=None, stream=None,
                 device=None, tune=None):
        if cfg is None:
            if topology is None:
                raise ConfigError(
                    "SecureAggregator needs a config: pass cfg=AggConfig"
                    "(...) or topology=Topology(n_nodes=...)")
            cfg = AggConfig.compose(topology, security or Security(),
                                    wire or Wire(), runtime)
        elif topology is not None or security is not None \
                or wire is not None:
            raise ConfigError(
                "pass either cfg= or the topology/security/wire "
                "sections, not both (use cfg.replace(...) to override)")
        elif runtime is not None and runtime.kernel_impl is not None:
            cfg = cfg.replace(kernel_impl=runtime.kernel_impl)
        self.cfg = cfg
        self.runtime = runtime or Runtime()
        self.device = resolve_device(device)
        self._plan: Optional[AggPlan] = None
        self._fns: dict = {}       # payload shape key -> callable
        self._indexes: dict = {}   # AggConfig -> RoundIndex on the device
        self._mesh_tp: Optional[_engine.MeshTransport] = None
        self._node_mesh = None     # the manual backend's default mesh
        self._wire_s = _engine.wire_seconds()
        self.metrics = _obs.registry_or_default(metrics)
        self.recorder = recorder
        self._c_fn_hits = self.metrics.counter(_obs.M_FACADE_FN_HITS)
        self._c_fn_misses = self.metrics.counter(_obs.M_FACADE_FN_MISSES)
        self._c_bytes = self.metrics.counter(_obs.M_FACADE_BYTES)
        self._batching = batching
        self._epochs = epochs
        self._retry = retry
        self._breaker = breaker
        self._chaos = chaos
        self._stream = stream
        self._svc = None
        if tune is None:
            self._tuner = None
        elif isinstance(tune, str):
            if tune not in ("auto", "probe"):
                raise ConfigError(
                    f"unknown tune mode {tune!r}; pick 'auto' (exact "
                    "cost oracle), 'probe' (oracle + measured "
                    "finalists), or pass a repro_torch.tune.Tuner")
            from repro_torch.tune import Tuner
            self._tuner = Tuner(probe=tune == "probe",
                                metrics=self.metrics,
                                epochs=self._epochs, device=self.device)
        elif hasattr(tune, "decide"):
            self._tuner = tune
        else:
            raise ConfigError(
                "tune= wants 'auto', 'probe', or a "
                f"repro_torch.tune.Tuner, got {type(tune).__name__}")
        self._tune_decisions: dict = {}   # WorkloadSignature -> decision
        self._tuned_rows: Optional[dict] = None  # service pad overrides
        self._func_sessions: dict = {}    # fid -> FuncSession (active)
        self._next_fid = 0

    # -- config / plan ------------------------------------------------------

    @property
    def backend(self) -> str:
        """Effective execution backend (``Runtime.backend`` resolved)."""
        return self.runtime.resolve()

    def plan(self) -> AggPlan:
        """The compiled :class:`AggPlan` of this config (shared memo)."""
        if self._plan is None:
            self._plan = compile_plan(self.cfg)
        return self._plan

    def derive(self, **kw) -> "SecureAggregator":
        """A sibling facade over ``cfg.derive(**kw)``: the same runtime,
        device, service knobs, registry, recorder and tuner; its caches
        start empty."""
        return SecureAggregator(self.cfg.derive(**kw), runtime=self.runtime,
                                batching=self._batching, epochs=self._epochs,
                                retry=self._retry, breaker=self._breaker,
                                chaos=self._chaos, metrics=self.metrics,
                                recorder=self.recorder, stream=self._stream,
                                device=self.device, tune=self._tuner)

    # -- self-tuning --------------------------------------------------------
    def _tune_decision(self, T: int, S: int = 1):
        """The tuned decision for this workload shape, memoised per
        facade by the full :class:`~repro_torch.tune.WorkloadSignature`
        (not just ``(T, S)``): a tuner watching an ``EpochManager`` folds
        the observed churn rate into the signature, so when the rate
        moves a quantum the same ``(T, S)`` resolves afresh."""
        sig = self._tuner.signature(self.cfg, T, S)
        d = self._tune_decisions.get(sig)
        if d is None:
            d = self._tuner.decide(self.cfg, sig)
            self._tune_decisions[sig] = d
        return d

    def _plan_for(self, T: int, S: int = 1):
        """(plan, decision) a verb executes: the tuned winner when tuning
        is on, else this config's own plan (decision None)."""
        if self._tuner is None:
            return self.plan(), None
        d = self._tune_decision(T, S)
        return compile_plan(d.config), d

    def _round_index(self, plan: AggPlan) -> _engine.RoundIndex:
        """The sim's gather maps of ``plan`` on the facade's device,
        built once a plan."""
        index = self._indexes.get(plan.cfg)
        if index is None:
            index = self._indexes[plan.cfg] = _engine.RoundIndex(
                plan, self.device)
        return index

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _cached(self, key, plan: AggPlan):
        """The cached callable under ``key`` when it was built on
        ``plan``, else None (the caller builds one); counts the hit or
        the miss."""
        fn = self._fns.get(key)
        if fn is not None and fn.plan is plan:
            self._c_fn_hits.inc()
            return fn
        self._c_fn_misses.inc()
        return None

    # -- one-shot aggregation ----------------------------------------------
    def allreduce(self, tree):
        """One-shot secure allreduce.

        ``sim`` / ``mesh`` backends: ``tree`` is a tensor (or a dict /
        list / tuple of tensors) whose leading axis is ``n_nodes``, the
        same on every rank of a mesh; returns the same structure of
        per-node aggregated results on the facade's device, bit-identical
        across backends.

        ``manual`` backend: every rank of the process group calls it with
        its own tree; chunk-pipelined over ``Wire.chunk_elems``."""
        leaves, rebuild = _engine.tree_flatten(tree)
        if not leaves:
            return tree
        leaves = [self._tensor(leaf) for leaf in leaves]
        backend = self.backend
        if backend == "manual":
            account = {"bytes_sent": 0, "wire_s": _engine.wire_seconds()}
            out = _engine.tree_allreduce(
                rebuild(leaves), self.cfg, self._manual_mesh(),
                self.runtime.dp_axes, account=account)
            self._c_bytes.inc(account["bytes_sent"])
            self._add_wire(account["wire_s"])
            return out
        n = self.cfg.n_nodes
        for leaf in leaves:
            if leaf.dim() < 1 or leaf.shape[0] != n:
                raise ConfigError(
                    f"allreduce payload leaves must have leading axis "
                    f"n_nodes={n} (per-node values), got shape "
                    f"{tuple(leaf.shape)}; for rank-local values use "
                    "Runtime(backend='manual')")
        shapes = tuple((tuple(leaf.shape), str(leaf.dtype))
                       for leaf in leaves)
        T = sum(math.prod(shape[1:]) for shape, _ in shapes)
        if T == 0:
            return tree          # every leaf zero-size: nothing moves
        plan, _ = self._plan_for(T)
        fn = self._executable(backend, _structure(tree), shapes, plan)
        outs = fn(leaves)
        self._c_bytes.inc(fn.last_bytes)
        self._add_wire(fn.last_wire_s)
        if self.recorder is not None:
            # the reference books the one-shot with fresh=False
            record_batch_trace(self.recorder, plan, padded=T, rows=1,
                               masks={}, unit=0, attempt=1,
                               backend=backend, sids=(), fresh=False)
        return rebuild(outs)

    def _executable(self, backend: str, structure, shapes, plan: AggPlan):
        """One callable a (backend, payload structure, leaf shapes), built
        on ``plan``: pack the leaves, run the engine, unpack.  It records
        its executed bytes and wire seconds on itself."""
        key = (backend, structure, shapes)
        fn = self._cached(key, plan)
        if fn is not None:
            return fn
        n, seed, device = self.cfg.n_nodes, self.cfg.seed, self.device
        sizes = [math.prod(shape[1:]) for shape, _ in shapes]
        mt = self._mesh_transport() if backend == "mesh" else None
        index = None if mt is not None else self._round_index(plan)

        def fn(leaves):
            flat = [leaf.reshape(n, -1).to(torch.float32) for leaf in leaves]
            xs = (flat[0] if len(flat) == 1 else torch.cat(flat, dim=1))[None]
            meta = SessionMeta.single(seed, device=device)
            if mt is not None:
                out = mt.execute(plan, xs, meta)
                fn.last_bytes, fn.last_wire_s = mt.last_bytes, mt.last_wire_s
            else:
                out, tp = _engine.sim_batch(plan, xs, meta, index=index)
                fn.last_bytes = tp.bytes_sent
            out = out[0]
            outs, off = [], 0
            for leaf, size in zip(leaves, sizes):
                outs.append(out[:, off:off + size].reshape(leaf.shape)
                            .to(leaf.dtype))
                off += size
            return outs

        fn.plan = plan
        fn.last_bytes, fn.last_wire_s = 0, _engine.wire_seconds()
        self._fns[key] = fn
        return fn

    def _add_wire(self, seconds: dict) -> None:
        for k, v in seconds.items():
            self._wire_s[k] += v

    def _mesh_transport(self) -> _engine.MeshTransport:
        if self._mesh_tp is None:
            self._mesh_tp = _engine.MeshTransport(
                self.runtime.mesh, self.runtime.dp_axes,
                impl=self.cfg.kernel_impl)
        return self._mesh_tp

    def _manual_mesh(self):
        """The manual backend's mesh: the runtime's, or the one-axis
        ``node_mesh`` of the started group (built once: its cluster
        groups are cached on it)."""
        if self.runtime.mesh is not None:
            return self.runtime.mesh
        if self._node_mesh is None:
            from repro_torch.runtime.compat import node_mesh
            if len(self.runtime.dp_axes) != 1:
                raise ConfigError(
                    f"backend='manual' over dp_axes={self.runtime.dp_axes} "
                    "needs Runtime(mesh=...)")
            self._node_mesh = node_mesh(self.cfg.n_nodes,
                                        self.runtime.dp_axes[0])
        return self._node_mesh

    def allreduce_batched(self, xs):
        """S independent aggregations in one pass: ``xs`` is
        ``(S, n_nodes, ...)`` per-node payloads; returns the ``(S, ...)``
        revealed per-session aggregates, each row bit-identical to
        ``allreduce`` of that row alone."""
        backend = self.backend
        if backend == "manual":
            raise ConfigError(
                "allreduce_batched runs the global batch on every rank, "
                "which the 'manual' backend does not take -- use "
                "Runtime(backend='sim') or Runtime(backend='mesh', mesh=...)")
        xs = self._tensor(xs)
        n = self.cfg.n_nodes
        if xs.dim() < 2 or xs.shape[1] != n:
            raise ConfigError(
                f"allreduce_batched wants (S, n_nodes={n}, ...) per-node "
                f"payloads, got shape {tuple(xs.shape)}")
        S = int(xs.shape[0])
        if S == 0 or xs.numel() == 0:
            return xs[:, 0]
        tail = tuple(xs.shape[2:])
        T = math.prod(tail)
        plan, _ = self._plan_for(T, S)
        key = ("batched", backend, S, T)
        fn = self._cached(key, plan)
        fresh = fn is None
        if fresh:
            if backend == "mesh":
                fn = _engine.build_batch_executable(
                    plan, backend="mesh", mesh=self.runtime.mesh,
                    dp_axes=self.runtime.dp_axes, impl=self.cfg.kernel_impl)
            else:
                fn = _engine.build_batch_executable(
                    plan, impl=self.cfg.kernel_impl, device=self.device,
                    index=self._round_index(plan))
            fn.plan = plan
            self._fns[key] = fn
        seeds = words([self.cfg.seed] * S, self.device)
        offsets = words([0] * S, self.device)
        out = fn(xs.reshape(S, n, T).to(torch.float32), seeds, offsets, {})
        self._c_bytes.inc(fn.last_bytes)
        self._add_wire(fn.last_wire_s)
        if self.recorder is not None:
            record_batch_trace(self.recorder, plan, padded=T, rows=S,
                               masks={}, unit=0, attempt=1,
                               backend=backend, sids=(), fresh=fresh)
        return out.reshape((S,) + tail).to(xs.dtype)

    # -- secure functions (repro_torch.funcs) --------------------------------
    def _func_plan(self, fn, *, bins=None, range=(0.0, 1.0), domain=None,
                   q=0.5, k=None):
        """Compile one secure function onto this config (the verbs' and
        ``open_session(fn=...)``'s shared front half).  ``domain`` is a
        ``ValueDomain`` or a ``(lo, hi, steps)`` tuple."""
        from repro_torch.funcs import ValueDomain
        if fn == "histogram":
            if bins is None:
                raise ConfigError("fn='histogram' needs bins=")
            lo, hi = range
            return compile_func_plan(self.cfg, "histogram",
                                     bins=int(bins), lo=float(lo),
                                     hi=float(hi))
        aliases = {"min": 0.0, "minimum": 0.0, "max": 1.0,
                   "maximum": 1.0, "median": 0.5}
        if fn in aliases:
            q = aliases[fn]
            fn = "quantile"
        if fn not in ("quantile", "topk"):
            raise ConfigError(
                f"unknown secure function {fn!r}; pick histogram, "
                "quantile, median, min, max, or topk")
        if domain is None:
            raise ConfigError(
                f"fn={fn!r} needs domain=ValueDomain(lo, hi, steps) "
                "(or a (lo, hi, steps) tuple) — the public value grid "
                "the bisection searches")
        dom = (domain if isinstance(domain, ValueDomain)
               else ValueDomain(*domain))
        if fn == "quantile":
            return compile_func_plan(self.cfg, "quantile", lo=dom.lo,
                                     hi=dom.hi, steps=dom.steps,
                                     q=float(q))
        if k is None:
            raise ConfigError("fn='topk' needs k=")
        return compile_func_plan(self.cfg, "topk", lo=dom.lo, hi=dom.hi,
                                 steps=dom.steps, k=int(k))

    def _run_func(self, fplan, values):
        """Run a function plan to its end with one-shot allreduces: one
        :meth:`allreduce` a protocol round, booked through the same
        callable cache, byte account and trace recorder as any other
        one-shot, plus one ``func_round`` span a round.  The revealed
        counts come to the host once a round (the reveal between rounds
        is the protocol)."""
        from repro_torch.funcs import FuncRun
        if self.backend == "manual":
            raise ConfigError(
                "secure functions run one allreduce per protocol round "
                "and reveal counts between rounds, which has no "
                "'manual' (rank-local) backend — use "
                "Runtime(backend='sim') or 'mesh'")
        run = FuncRun(fplan, values)
        while not run.done:
            T = run.payload_elems
            rnd = run.round
            out = self.allreduce(torch.from_numpy(run.next_payload()))
            run.feed(out[0])
            if self.recorder is not None:
                plan, _ = self._plan_for(T)
                record_func_round(self.recorder, fn=fplan.fn, rnd=rnd,
                                  rounds=run.n_rounds, elems=T,
                                  bytes=plan.wire_bytes(T),
                                  backend=self.backend)
        return run.result

    def histogram(self, values, bins: int, *, range=(0.0, 1.0)):
        """Secure frequency count: how many nodes hold a value in each of
        ``bins`` equal bins over ``range``, ``np.histogram`` semantics
        (out-of-range values clip into the range).  One allreduce of
        one-hot rows; returns the (bins,) int64 counts, exact."""
        return self._run_func(
            self._func_plan("histogram", bins=bins, range=range), values)

    def quantile(self, values, q: float, *, domain):
        """Secure order statistic: the ``max(1, ceil(q * n))``-th smallest
        of the nodes' values on ``domain``'s grid, by threshold-count
        bisection: ``ceil(log2(steps))`` allreduces of a 1-element
        count, a round count fixed by the domain, never the data."""
        return self._run_func(
            self._func_plan("quantile", domain=domain, q=q), values)

    def median(self, values, *, domain):
        """Secure (lower) median: :meth:`quantile` at q=0.5."""
        return self._run_func(
            self._func_plan("median", domain=domain), values)

    def minimum(self, values, *, domain):
        """Secure minimum: :meth:`quantile` at q=0."""
        return self._run_func(
            self._func_plan("minimum", domain=domain), values)

    def maximum(self, values, *, domain):
        """Secure maximum: :meth:`quantile` at q=1."""
        return self._run_func(
            self._func_plan("maximum", domain=domain), values)

    def topk(self, values, k: int, *, domain):
        """Secure top-k: the k largest node values (descending, with
        multiplicity) on ``domain``'s grid: the bisection finds the
        k-th-largest threshold, then one full-domain histogram of the
        values above it reads the winners off."""
        return self._run_func(
            self._func_plan("topk", domain=domain, k=k), values)

    def _open_func_session(self, fplan, *, now=None, ttl=None):
        """Back half of ``open_session(fn=...)``: the service, the
        function pad rule, the registered session."""
        from repro_torch.funcs import FuncSession
        from repro_torch.service import SessionParams
        if self._svc is None:
            widest = max(fplan.round_elems, default=1)
            self._service(SessionParams.from_config(self.cfg, widest))
        if self._tuner is None:
            # keep function rounds batch-tight (1-element bisection
            # counts stay 1 element); with tuning on the tuner's own
            # decisions own the pad map instead
            self._svc.queue.batching.register_func_elems(
                fplan.round_elems)
        fs = FuncSession(self, fplan, self._next_fid, ttl=ttl)
        self._next_fid += 1
        self._func_sessions[fs.fid] = fs
        return fs

    # -- session service ----------------------------------------------------
    @property
    def service(self):
        """The lazily-built :class:`~repro_torch.service.AggregationService`
        behind :meth:`open_session` (None until the first session)."""
        return self._svc

    def open_session(self, elems: Optional[int] = None, *, fn=None,
                     params=None, now=None, ttl=None, bins=None,
                     range=(0.0, 1.0), domain=None, q=0.5, k=None):
        """Open one aggregation query of ``elems`` elements per node, or
        with ``fn=`` one multi-round secure function session.

        ``params`` (a ``SessionParams``) overrides the defaults derived
        from the shared config via ``SessionParams.from_config`` (with
        tuning on, from the tuned config at the service's batch width).
        A static ``Security.byzantine`` fault model is injected into the
        session (as a ``SessionFaultPlan``), so both facade verbs honor
        the same config.  ``ttl`` (default ``BatchingConfig.session_ttl``)
        sets the session deadline on the open/seal/pump clock.  Returns
        the :class:`~repro_torch.service.Session`; drive it with
        ``contribute(...)`` then :meth:`seal` / :meth:`pump` /
        :meth:`result`.

        ``fn`` opens a :class:`~repro_torch.funcs.FuncSession` instead:
        ``"histogram"`` (``bins`` / ``range``), ``"quantile"``
        (``domain`` and ``q``), ``"median"`` / ``"min"`` / ``"max"``
        (``domain``) or ``"topk"`` (``domain`` and ``k``).  Nodes
        ``contribute(slot, scalar)``; after ``seal()`` every protocol
        round rides the service as an inner session (concurrent
        functions batch their rounds together), advanced by this
        facade's :meth:`pump` / :meth:`drain`."""
        from repro_torch.service import SessionParams
        if fn is not None:
            if elems is not None or params is not None:
                raise ConfigError(
                    "open_session(fn=...) derives its payload lengths "
                    "from the function plan — don't pass elems/params")
            fplan = self._func_plan(fn, bins=bins, range=range,
                                    domain=domain, q=q, k=k)
            return self._open_func_session(fplan, now=now, ttl=ttl)
        if elems is None:
            raise ConfigError(
                "open_session needs elems (additive aggregation) or "
                "fn= (a secure function)")
        decision = None
        if params is None:
            if self._tuner is not None:
                # resolve at the batch width the executor dispatches and
                # derive the params from the winning config, so the
                # executor's plan and its wire account are the tuned ones
                decision = self._tune_decision(elems, self._batch_rows())
                params = SessionParams.from_config(decision.config, elems)
            else:
                params = SessionParams.from_config(self.cfg, elems)
        svc = self._service(params)
        if decision is not None and self._tuned_rows is not None:
            # the padded length is part of the batch key, so tuned and
            # untuned sessions of one elems never share a batch
            self._tuned_rows[elems] = decision.padded_elems
        session = svc.open(params=params, now=now, ttl=ttl)
        byz = self.cfg.byzantine
        if byz.corrupt_ranks:
            from repro_torch.runtime.fault import SessionFaultPlan
            session.inject_fault(SessionFaultPlan(
                byzantine_slots=tuple(byz.corrupt_ranks),
                byzantine_mode=byz.mode))
        return session

    def _batch_rows(self) -> int:
        """The batch width S the executor dispatches at: the tuned
        workload signature's S on the service path."""
        if self._batching is not None:
            return self._batching.max_batch
        from repro_torch.service import BatchingConfig
        return BatchingConfig.max_batch

    def _service(self, default_params):
        if self._svc is None:
            from repro_torch.service import (AggregationService,
                                             BatchingConfig)
            backend = self.backend
            if backend == "manual":
                raise ConfigError(
                    "sessions run on the batched executor, which has no "
                    "'manual' backend — use Runtime(backend='sim') or "
                    "Runtime(backend='mesh', mesh=...) for open_session "
                    "(manual is the rank-local allreduce path)")
            batching = self._batching or BatchingConfig()
            # every service gets a live per-elems pad map: the tuner
            # writes its padded rows here as sessions open, and function
            # sessions register the function pad rule; a caller's map is
            # used as it is, so its entries stay live
            if batching.tuned is None:
                batching = dataclasses.replace(batching, tuned={})
            self._tuned_rows = batching.tuned
            self._svc = AggregationService(
                default_params,
                epochs=self._epochs,
                batching=batching,
                kernel_impl=self.cfg.kernel_impl,
                base_seed=self.cfg.seed,
                transport="mesh" if backend == "mesh" else "sim",
                mesh=self.runtime.mesh, dp_axes=self.runtime.dp_axes,
                retry=self._retry, breaker=self._breaker,
                chaos=self._chaos, metrics=self.metrics,
                recorder=self.recorder, stream=self._stream,
                device=self.device)
        return self._svc

    def seal(self, sid: int, now=None) -> None:
        self._require_service().seal(sid, now=now)

    def pump(self, now=None, force: bool = False) -> int:
        """Flush ready service batches, then advance every function
        session whose round just revealed (each opens and seals its next
        round, which the following pump runs: one pump a bisection
        round).  Returns the sessions the service pump revealed."""
        revealed = self._require_service().pump(now=now, force=force)
        self._advance_funcs(now)
        return revealed

    def drain(self) -> int:
        """Force-flush everything pending; function sessions are driven
        to a terminal state (one service drain a remaining round,
        bounded by the static round count)."""
        svc = self._require_service()
        total = svc.drain()
        self._advance_funcs(None)
        while any(fs.state == "running"
                  for fs in self._func_sessions.values()):
            total += svc.drain()
            if not self._advance_funcs(None):
                break          # no inner session progressed: stuck/failed
        return total

    def result(self, sid: int, evict: bool = False):
        return self._require_service().result(sid, evict=evict)

    def _advance_funcs(self, now) -> int:
        """Advance the in-flight function sessions; returns how many
        progressed.  Terminal ones leave the active set (the caller's
        FuncSession handle keeps the result)."""
        progressed = 0
        for fid, fs in list(self._func_sessions.items()):
            if fs.advance(now):
                progressed += 1
            if fs.state in ("done", "failed"):
                del self._func_sessions[fid]
        return progressed

    def _require_service(self):
        if self._svc is None:
            raise ConfigError("no session opened yet — call "
                              "open_session(elems) first")
        return self._svc

    # -- accounting ---------------------------------------------------------
    def cost(self, elems: Optional[int] = None, *, fn=None, bins=None,
             range=(0.0, 1.0), domain=None, q=0.5, k=None) -> dict:
        """Analytic per-run communication account at ``elems`` float32
        payload elements: ``schedules.schedule_cost`` with the exact
        digest parameters, equal to the engine's executed wire bytes.
        With tuning on it describes the tuned config this facade would
        run for ``elems`` (at S=1).

        ``fn=`` (with :meth:`open_session`'s function keywords) accounts
        a multi-round secure function: the per-allreduce bytes summed
        over the plan's static rounds, each round's plan resolved as the
        verbs resolve it, so the total equals the executed bytes summed
        over every round."""
        if fn is not None:
            if elems is not None:
                raise ConfigError(
                    "cost(fn=...) derives its payload lengths from the "
                    "function plan — don't pass elems")
            fplan = self._func_plan(fn, bins=bins, range=range,
                                    domain=domain, q=q, k=k)
            total = rounds = 0
            per_round = []
            for T in fplan.round_elems:
                plan, _ = self._plan_for(T)
                b = plan.wire_bytes(T)
                per_round.append(b)
                total += b
                rounds += len(plan.rounds)
            return {"fn": fplan.fn,
                    "allreduces": fplan.n_allreduces,
                    "round_elems": fplan.round_elems,
                    "rounds": rounds,
                    "bytes_per_allreduce": tuple(per_round),
                    "bytes_total": total,
                    "bytes_per_node": total // self.cfg.n_nodes}
        if elems is None:
            raise ConfigError(
                "cost needs elems (additive aggregation) or fn= (a "
                "secure function)")
        cfg = self.cfg
        if self._tuner is not None:
            cfg = self._tune_decision(elems).config
        return schedule_cost(cfg.schedule, cfg.n_clusters, cfg.cluster_size,
                             cfg.redundancy, payload_bytes=4 * elems,
                             digest=cfg.transport == "digest",
                             digest_bytes=4 * cfg.digest_words,
                             digest_backup=cfg.digest_backup)

    def stats(self) -> dict:
        """The resolved backend, the shared plan-cache counters, this
        facade's callable cache (``fn_cache``), the wire bytes its runs
        executed (the engine's
        ``Transport.bytes_sent``, summed; on a mesh, this rank's account,
        which is the whole run's), and on the ``mesh`` / ``manual``
        backends the host seconds this rank spent on the wire (staging
        copies and waits on transfers), by kind: the hops, the cluster
        sums and the gathers of results.  ``metrics`` is the registry
        snapshot the service shares; with tuning on, ``tuner`` holds the
        tuner's counters; once a session has been opened, ``service``
        holds the service's stats and ``degraded`` flags a service
        running on the sim fallback (open circuit breaker)."""
        out = {
            "backend": self.backend,
            "device": str(self.device),
            "plan_cache": plan_cache_stats(),
            "fn_cache": {"hits": self._c_fn_hits.value,
                         "misses": self._c_fn_misses.value,
                         "size": len(self._fns)},
            "bytes_sent": self._c_bytes.value,
            "wire_s": dict(self._wire_s),
            "metrics": self.metrics.snapshot(),
        }
        if self._tuner is not None:
            out["tuner"] = self._tuner.stats()
        if self._svc is not None:
            out["service"] = self._svc.stats
            brk = self._svc.executor.breaker
            out["degraded"] = brk is not None and brk.state == "open"
        return out

