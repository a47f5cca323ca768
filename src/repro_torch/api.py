"""The front door of the port: :class:`SecureAggregator`.

Counterpart of ``repro/api.py`` for the single-device oracle (``sim``
backend): :meth:`~SecureAggregator.allreduce` aggregates per-node
payloads (a tensor, or a dict / list / tuple of tensors, each with
leading axis ``n_nodes``), :meth:`~SecureAggregator.allreduce_batched`
runs S independent sessions in one pass, and
:meth:`~SecureAggregator.cost` is the analytic wire account, equal to
the engine's executed bytes.

The facade runs on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises where there is none.  On the
card the three tensor stages launch the CUDA kernels;
``Runtime(kernel_impl="torch")`` asks for the plain versions instead.

    from repro_torch import SecureAggregator, Topology

    agg = SecureAggregator(topology=Topology(n_nodes=16))
    per_node = agg.allreduce(xs)          # xs: (16, T) payloads
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import engine as _engine
from repro_torch.core.plan import (AggConfig, AggPlan, ConfigError, Runtime,
                                   Security, SessionMeta, Topology, Wire,
                                   compile_plan, plan_cache_stats, words)
from repro_torch.core.schedules import schedule_cost
from repro_torch.kernels.backend import resolve_device

__all__ = ["AggConfig", "ConfigError", "Runtime", "SecureAggregator",
           "Security", "SessionMeta", "Topology", "Wire", "compile_plan",
           "plan_cache_stats"]

_LATER = {
    "service": "the service slice (ROADMAP Queue 1 item 6)",
    "funcs": "the tuner and secure-function slice (ROADMAP Queue 1 item 7)",
}


def _later(what: str, slice_key: str) -> ConfigError:
    return ConfigError(f"{what} is not ported yet; it comes with "
                       f"{_LATER[slice_key]}")


def _flatten(tree):
    """A tensor or a dict / list / tuple of them -> (leaves, rebuild).
    Dict keys are taken in sorted order, as the reference flattens them,
    so the leaves concatenate in the same order on both sides."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda vals: vals[0]
    leaves = [leaf for ls, _ in parts for leaf in ls]

    def rebuild(vals):
        out, i = [], 0
        for ls, re in parts:
            out.append(re(vals[i:i + len(ls)]))
            i += len(ls)
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


class SecureAggregator:
    """Facade over the plan / engine / transport core, constructed from
    the composable config model: pass a ready :class:`AggConfig` or the
    sections (``topology`` required, ``security`` / ``wire`` optional).
    ``runtime`` picks the kernel engine; ``device`` where the run lives
    (``None`` = the card)."""

    def __init__(self, cfg: Optional[AggConfig] = None, *,
                 topology: Optional[Topology] = None,
                 security: Optional[Security] = None,
                 wire: Optional[Wire] = None,
                 runtime: Optional[Runtime] = None,
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
        self._bytes = 0

    # -- config / plan ------------------------------------------------------

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
        """One-shot secure allreduce of per-node payloads: ``tree`` is a
        tensor (or a dict / list / tuple of tensors) whose leading axis is
        ``n_nodes``; returns the same structure of per-node aggregated
        results on the facade's device."""
        leaves, rebuild = _flatten(tree)
        if not leaves:
            return tree
        n = self.cfg.n_nodes
        leaves = [self._tensor(leaf) for leaf in leaves]
        for leaf in leaves:
            if leaf.dim() < 1 or leaf.shape[0] != n:
                raise ConfigError(
                    f"allreduce payload leaves must have leading axis "
                    f"n_nodes={n} (per-node values), got shape "
                    f"{tuple(leaf.shape)}")
        sizes = [math.prod(leaf.shape[1:]) for leaf in leaves]
        T = sum(sizes)
        if T == 0:
            return tree          # every leaf zero-size: nothing moves
        flat = [leaf.reshape(n, -1).to(torch.float32) for leaf in leaves]
        xs = (flat[0] if len(flat) == 1 else torch.cat(flat, dim=1))[None]
        meta = SessionMeta.single(self.cfg.seed, device=self.device)
        out, tp = _engine.sim_batch(self.plan(), xs, meta,
                                    index=self._round_index())
        self._bytes += tp.bytes_sent
        out = out[0]
        outs, off = [], 0
        for leaf, size in zip(leaves, sizes):
            outs.append(out[:, off:off + size].reshape(leaf.shape)
                        .to(leaf.dtype))
            off += size
        return rebuild(outs)

    def allreduce_batched(self, xs):
        """S independent aggregations in one pass: ``xs`` is
        ``(S, n_nodes, ...)`` per-node payloads; returns the ``(S, ...)``
        revealed per-session aggregates, each row bit-identical to
        ``allreduce`` of that row alone."""
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
            self._batched = _engine.build_batch_executable(
                self.plan(), impl=self.cfg.kernel_impl, device=self.device,
                index=self._round_index())
        fn = self._batched
        seeds = words([self.cfg.seed] * S, self.device)
        offsets = words([0] * S, self.device)
        out = fn(xs.reshape(S, n, T).to(torch.float32), seeds, offsets, {})
        self._bytes += fn.last_bytes
        return out.reshape((S,) + tail).to(xs.dtype)

    # -- later slices ---------------------------------------------------------
    def open_session(self, *a, **kw):
        raise _later("open_session", "service")

    def seal(self, *a, **kw):
        raise _later("seal", "service")

    def pump(self, *a, **kw):
        raise _later("pump", "service")

    def drain(self, *a, **kw):
        raise _later("drain", "service")

    def result(self, *a, **kw):
        raise _later("result", "service")

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
        """The shared plan-cache counters and the wire bytes this facade's
        runs executed (the engine's ``Transport.bytes_sent``, summed)."""
        return {
            "backend": "sim",
            "device": str(self.device),
            "plan_cache": plan_cache_stats(),
            "bytes_sent": self._bytes,
        }

