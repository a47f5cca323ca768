"""The front door of the port: :class:`SecureAggregator`.

Counterpart of ``repro/api.py``: :meth:`~SecureAggregator.allreduce`
aggregates per-node payloads (a tensor, or a dict / list / tuple of
tensors, each with leading axis ``n_nodes``),
:meth:`~SecureAggregator.allreduce_batched` runs S independent sessions
in one pass, :meth:`~SecureAggregator.open_session` opens one query of
the multi-session service (``seal`` / ``pump`` / ``drain`` / ``result``
delegate to it), and :meth:`~SecureAggregator.cost` is the analytic wire
account, equal to the engine's executed bytes.  The ``Runtime`` section
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
                                   compile_plan, plan_cache_stats, words)
from repro_torch.core.schedules import schedule_cost
from repro_torch.kernels.backend import resolve_device
from repro_torch.obs import metrics as _obs

__all__ = ["AggConfig", "ConfigError", "Runtime", "SecureAggregator",
           "Security", "SessionMeta", "Topology", "Wire", "compile_plan",
           "plan_cache_stats"]

_LATER = {
    "funcs": "the tuner and secure-function slice (ROADMAP Queue 1 item 7)",
}


def _later(what: str, slice_key: str) -> ConfigError:
    return ConfigError(f"{what} is not ported yet; it comes with "
                       f"{_LATER[slice_key]}")


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
    :class:`~repro_torch.obs.TraceRecorder`; both reach the service."""

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
        if tune is not None:
            raise _later("tune=", "funcs")
        self.cfg = cfg
        self.runtime = runtime or Runtime()
        self.device = resolve_device(device)
        self._plan: Optional[AggPlan] = None
        self._index: Optional[_engine.RoundIndex] = None
        self._batched = None       # the batch-reveal callable, any (S, T)
        self._mesh_tp: Optional[_engine.MeshTransport] = None
        self._node_mesh = None     # the manual backend's default mesh
        self._wire_s = _engine.wire_seconds()
        self.metrics = _obs.registry_or_default(metrics)
        self.recorder = recorder
        self._c_bytes = self.metrics.counter(_obs.M_FACADE_BYTES)
        self._batching = batching
        self._epochs = epochs
        self._retry = retry
        self._breaker = breaker
        self._chaos = chaos
        self._stream = stream
        self._svc = None

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
        """A sibling facade over ``cfg.derive(**kw)`` on the same runtime
        and device (caches start empty)."""
        return SecureAggregator(self.cfg.derive(**kw), runtime=self.runtime,
                                device=self.device)

    def _round_index(self) -> _engine.RoundIndex:
        if self._index is None:
            self._index = _engine.RoundIndex(self.plan(), self.device)
        return self._index

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

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
        if self.backend == "manual":
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
        sizes = [math.prod(leaf.shape[1:]) for leaf in leaves]
        T = sum(sizes)
        if T == 0:
            return tree          # every leaf zero-size: nothing moves
        flat = [leaf.reshape(n, -1).to(torch.float32) for leaf in leaves]
        xs = (flat[0] if len(flat) == 1 else torch.cat(flat, dim=1))[None]
        meta = SessionMeta.single(self.cfg.seed, device=self.device)
        if self.backend == "mesh":
            mt = self._mesh_transport()
            out = mt.execute(self.plan(), xs, meta)
            self._c_bytes.inc(mt.last_bytes)
            self._add_wire(mt.last_wire_s)
        else:
            out, tp = _engine.sim_batch(self.plan(), xs, meta,
                                        index=self._round_index())
            self._c_bytes.inc(tp.bytes_sent)
        out = out[0]
        outs, off = [], 0
        for leaf, size in zip(leaves, sizes):
            outs.append(out[:, off:off + size].reshape(leaf.shape)
                        .to(leaf.dtype))
            off += size
        return rebuild(outs)

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
        if self.backend == "manual":
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
        if self._batched is None:
            if self.backend == "mesh":
                self._batched = _engine.build_batch_executable(
                    self.plan(), backend="mesh", mesh=self.runtime.mesh,
                    dp_axes=self.runtime.dp_axes, impl=self.cfg.kernel_impl)
            else:
                self._batched = _engine.build_batch_executable(
                    self.plan(), impl=self.cfg.kernel_impl,
                    device=self.device, index=self._round_index())
        fn = self._batched
        seeds = words([self.cfg.seed] * S, self.device)
        offsets = words([0] * S, self.device)
        out = fn(xs.reshape(S, n, T).to(torch.float32), seeds, offsets, {})
        self._c_bytes.inc(fn.last_bytes)
        self._add_wire(fn.last_wire_s)
        return out.reshape((S,) + tail).to(xs.dtype)

    # -- session service ----------------------------------------------------
    @property
    def service(self):
        """The lazily-built :class:`~repro_torch.service.AggregationService`
        behind :meth:`open_session` (None until the first session)."""
        return self._svc

    def open_session(self, elems: Optional[int] = None, *, fn=None,
                     params=None, now=None, ttl=None, **kw):
        """Open one aggregation query of ``elems`` elements per node.

        ``params`` (a ``SessionParams``) overrides the defaults derived
        from the shared config via ``SessionParams.from_config``.  A
        static ``Security.byzantine`` fault model is injected into the
        session (as a ``SessionFaultPlan``), so both facade verbs honor
        the same config.  ``ttl`` (default ``BatchingConfig.session_ttl``)
        sets the session deadline on the open/seal/pump clock.  Returns
        the :class:`~repro_torch.service.Session`; drive it with
        ``contribute(...)`` then :meth:`seal` / :meth:`pump` /
        :meth:`result`.  ``fn=`` (a secure-function session) comes with
        the funcs slice."""
        from repro_torch.service import SessionParams
        if fn is not None or kw:
            raise _later("open_session(fn=...)", "funcs")
        if elems is None:
            raise ConfigError(
                "open_session needs elems (additive aggregation) or "
                "fn= (a secure function)")
        if params is None:
            params = SessionParams.from_config(self.cfg, elems)
        svc = self._service(params)
        session = svc.open(params=params, now=now, ttl=ttl)
        byz = self.cfg.byzantine
        if byz.corrupt_ranks:
            from repro_torch.runtime.fault import SessionFaultPlan
            session.inject_fault(SessionFaultPlan(
                byzantine_slots=tuple(byz.corrupt_ranks),
                byzantine_mode=byz.mode))
        return session

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
            if batching.tuned is None:
                batching = dataclasses.replace(batching, tuned={})
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
        """Flush ready service batches; returns sessions revealed."""
        return self._require_service().pump(now=now, force=force)

    def drain(self) -> int:
        """Force-flush everything pending."""
        return self._require_service().drain()

    def result(self, sid: int, evict: bool = False):
        return self._require_service().result(sid, evict=evict)

    def _require_service(self):
        if self._svc is None:
            raise ConfigError("no session opened yet — call "
                              "open_session(elems) first")
        return self._svc

    # -- later slices ---------------------------------------------------------
    def histogram(self, *a, **kw):
        raise _later("histogram", "funcs")

    def quantile(self, *a, **kw):
        raise _later("quantile", "funcs")

    def median(self, *a, **kw):
        raise _later("median", "funcs")

    def minimum(self, *a, **kw):
        raise _later("minimum", "funcs")

    def maximum(self, *a, **kw):
        raise _later("maximum", "funcs")

    def topk(self, *a, **kw):
        raise _later("topk", "funcs")

    # -- accounting ---------------------------------------------------------
    def cost(self, elems: Optional[int] = None, *, fn=None, **kw) -> dict:
        """Analytic per-run communication account at ``elems`` float32
        payload elements: ``schedules.schedule_cost`` with the exact digest
        parameters, equal to the engine's executed wire bytes."""
        if fn is not None:
            raise _later("cost(fn=...)", "funcs")
        if elems is None:
            raise ConfigError("cost needs elems (additive aggregation)")
        cfg = self.cfg
        return schedule_cost(cfg.schedule, cfg.n_clusters, cfg.cluster_size,
                             cfg.redundancy, payload_bytes=4 * elems,
                             digest=cfg.transport == "digest",
                             digest_bytes=4 * cfg.digest_words,
                             digest_backup=cfg.digest_backup)

    def stats(self) -> dict:
        """The resolved backend, the shared plan-cache counters and the
        wire bytes this facade's runs executed (the engine's
        ``Transport.bytes_sent``, summed; on a mesh, this rank's account,
        which is the whole run's), and on the ``mesh`` / ``manual``
        backends the host seconds this rank spent on the wire (staging
        copies and waits on transfers), by kind: the hops, the cluster
        sums and the gathers of results.  ``metrics`` is the registry
        snapshot the service shares; once a session has been opened,
        ``service`` holds the service's stats and ``degraded`` flags a
        service running on the sim fallback (open circuit breaker)."""
        out = {
            "backend": self.backend,
            "device": str(self.device),
            "plan_cache": plan_cache_stats(),
            "bytes_sent": self._c_bytes.value,
            "wire_s": dict(self._wire_s),
            "metrics": self.metrics.snapshot(),
        }
        if self._svc is not None:
            out["service"] = self._svc.stats
            brk = self._svc.executor.breaker
            out["degraded"] = brk is not None and brk.state == "open"
        return out

