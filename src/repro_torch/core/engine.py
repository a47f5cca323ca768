"""One protocol engine, pluggable transports.

Counterpart of ``repro/core/engine.py``.  ``execute_chunks`` runs a
compiled :class:`~repro_torch.core.plan.AggPlan` stage by stage --
encrypt, intra-cluster sum, voted schedule rounds, threshold decrypt --
against a :class:`Transport`, which only moves bits:

  * :class:`SimTransport`    -- the single-device oracle: the node axis
    is explicit and hops are gathers whose index tensors are built once
    per round on the run's device.  Everything else is pinned against it.
  * :class:`ManualTransport` -- one rank of a ``torch.distributed`` group
    per protocol node (a :class:`~repro_torch.runtime.compat.NodeMesh`):
    hops are paired ``isend`` / ``irecv``, the intra-cluster sum an
    ``all_reduce`` on the rank's cluster group.  ``manual_allreduce`` /
    ``tree_allreduce`` run a rank-local payload on it.
  * :class:`MeshTransport`   -- takes the global (S, n, T) batch on every
    rank, runs :class:`ManualTransport` on the rank's column and gathers
    the per-node results back, as the reference's ``shard_map`` does.

Values are ``(rows, T)`` tensors with ``rows = S * local nodes`` (all n
on the oracle, one a rank on a mesh): float32 payloads in, int32 words
(uint32 bits) between stages, float32 out.  The three tensor stages go
through the dispatch ops of ``kernels/secure_agg``, so on a CUDA tensor
they launch the CUDA kernels, in every rank.  The fault model and the
hop assembly (``Transport.hop`` / ``_sent`` / ``vote``) are shared by all
transports, which supply only their primitives: that is what makes them
bit-identical.  Every hop also feeds ``Transport.bytes_sent``, the
bandwidth account that equals ``schedules.schedule_cost`` on every rank.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.byzantine import (digest_rows, digest_vote_combine,
                                        equivocate_digest,
                                        equivocate_payload, parse_mode,
                                        sent_value)
from repro_torch.core.plan import (AggPlan, ConfigError, HopRound,
                                   SessionMeta, compile_plan, hop_wire_words)
from repro_torch.kernels import backend
from repro_torch.kernels.secure_agg import (mask_encrypt_batch_fn,
                                            unmask_decrypt_batch_fn,
                                            vote_combine_batch_fn)
from repro_torch.kernels.secure_agg.secure_agg import narrow, wide
from repro_torch.runtime.compat import (TAG_SPACE, flat_node_id,
                                        ranks_by_node, slice_of, subgroup)

_ENC_MODE = {"global": "mask", "pairwise": "pairwise", "none": "quantize"}


def _active_bases(items, rnd_idx: int) -> set:
    """Base fault modes in effect at voted round ``rnd_idx``."""
    out = set()
    for mode, _ in items:
        base, frm = parse_mode(mode)
        if rnd_idx >= frm:
            out.add(base)
    return out


class Transport:
    """Communication substrate an :class:`AggPlan` executes against.

    ``S`` is the session count; values are ``(rows, T)`` tensors with
    ``rows = S * local_nodes``.  Subclasses define who the local rows
    belong to and how bits move between nodes."""

    S: int
    impl: Optional[str]
    plan: AggPlan
    device: torch.device
    bytes_sent: int = 0
    _static_faults: Optional[list] = None

    def _fault_items(self, meta: SessionMeta) -> list:
        """Ordered fault sources: the plan's static specs first, lowered
        once to (n,) bool masks on the device, then the per-session
        runtime (S, n) masks in ``meta.fault_masks`` order."""
        if self._static_faults is None:
            items = []
            n = self.plan.n_nodes
            for spec in self.plan.faults:
                m = torch.zeros((n,), dtype=torch.bool, device=self.device)
                m[list(spec.corrupt_ranks)] = True
                items.append((spec.mode, m))
            self._static_faults = items
        return self._static_faults + list(meta.fault_masks.items())

    def node_ids(self) -> torch.Tensor:
        """(rows,) int32 protocol node id of every row."""
        raise NotImplementedError

    def expand(self, per_session: torch.Tensor) -> torch.Tensor:
        """(S,) per-session metadata -> (rows,) per-row metadata."""
        raise NotImplementedError

    def cluster_sum(self, q: torch.Tensor) -> torch.Tensor:
        """Intra-cluster modular sum, replicated to every member."""
        raise NotImplementedError

    def _wire(self, acc: torch.Tensor) -> torch.Tensor:
        """Row tensor -> the transport's fault-model view."""
        return acc

    def _sel(self, m: torch.Tensor) -> torch.Tensor:
        """(n,) static or (S, n) runtime fault mask -> a bool selector
        broadcastable over the wire view."""
        raise NotImplementedError

    def _digest(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _move(self, rnd: HopRound, stream: int, x: torch.Tensor
              ) -> torch.Tensor:
        """Ship ``x`` (wire view) along copy stream ``stream``."""
        raise NotImplementedError

    def _move_backup(self, rnd: HopRound, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # -- shared fault application + hop assembly: every transport runs
    # exactly this code against its primitives ---------------------------
    def _sent(self, items, rnd_idx: int, honest: torch.Tensor, view: str,
              stream: Optional[int] = None) -> torch.Tensor:
        """Apply the fault model to the honest wire view for one wire
        (``stream`` set = full-transport per-stream equivocation)."""
        sent = honest
        for mode, m in items:
            base, frm = parse_mode(mode)
            if rnd_idx < frm:
                continue
            if base == "equivocate" and stream is not None:
                bad = equivocate_payload(honest, stream)
            else:
                bad = sent_value(base, view, honest)
            sent = torch.where(self._sel(m), bad, sent)
        return sent

    def _equiv_sel(self, items, rnd_idx: int):
        """Union selector of active equivocating nodes, or None."""
        sel = None
        for mode, m in items:
            base, frm = parse_mode(mode)
            if base != "equivocate" or rnd_idx < frm:
                continue
            sel = self._sel(m) if sel is None else sel | self._sel(m)
        return sel

    def hop(self, rnd: HopRound, rnd_idx: int, meta: SessionMeta,
            acc: torch.Tensor):
        """Apply the fault model to the sent wire views and move one
        round's redundant copies: a list of r payload copies for the full
        transport, ``(payload, digest_copies, backup)`` for digest."""
        self._account(rnd, acc.shape[-1])
        cfg = self.plan.cfg
        r = self.plan.redundancy
        items = self._fault_items(meta)
        w = self._wire(acc)
        if cfg.transport == "full":
            if "equivocate" not in _active_bases(items, rnd_idx):
                sent = self._sent(items, rnd_idx, w, "payload")
                return [self._move(rnd, s, sent) for s in range(r)]
            return [self._move(rnd, s,
                               self._sent(items, rnd_idx, w, "payload",
                                          stream=s)) for s in range(r)]
        pay = self._sent(items, rnd_idx, w, "payload")
        dg = self._digest(self._sent(items, rnd_idx, w, "digest"))
        em = self._equiv_sel(items, rnd_idx)
        payload = self._move(rnd, 0, pay)
        dg_copies = [
            self._move(rnd, s, dg if em is None
                       else torch.where(em, equivocate_digest(dg, s), dg))
            for s in range(r)]
        backup = (self._move_backup(rnd, pay)
                  if cfg.digest_backup else None)
        return payload, dg_copies, backup

    def vote(self, rnd: HopRound, inflight, base: torch.Tensor
             ) -> torch.Tensor:
        """base + majority(inflight) -- one fused pass per transport."""
        if self.plan.cfg.transport == "full":
            return vote_combine_batch_fn(inflight, base, impl=self.impl)
        payload, dg_copies, backup = inflight
        return digest_vote_combine(payload, dg_copies, base, backup=backup,
                                   n_words=self.plan.cfg.digest_words)

    def select(self, rnd: HopRound, voted: torch.Tensor,
               acc: torch.Tensor) -> torch.Tensor:
        """Keep ``voted`` on nodes that participate this round."""
        raise NotImplementedError

    def reveal_rows(self, accs: list, meta: SessionMeta):
        """Narrow to one revealed row per session ->
        (accs', row_seeds', row_offsets')."""
        raise NotImplementedError

    def _account(self, rnd: HopRound, T: int) -> None:
        """Bandwidth account of one hop of one chunk (the plan's
        ``hop_wire_words``)."""
        w = hop_wire_words(self.plan.cfg, rnd, T)
        self.bytes_sent += 4 * (w["payload"] + w["digest"] + w["backup"]) \
            * self.S


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _vote_base(rnd: HopRound, acc: torch.Tensor,
               local: torch.Tensor) -> torch.Tensor:
    if rnd.combine == "add":
        return acc
    if rnd.combine == "local_plus":
        return local
    return torch.zeros_like(acc)  # replace (tree broadcast-down)


def execute_chunks(plan: AggPlan, tp: Transport, chunks: list,
                   meta: SessionMeta, *, reveal_only: bool = False) -> list:
    """Run the full protocol over equal-size float32 chunks.

    ``chunks[k]`` is (rows, Tc) and covers pad-stream positions
    ``[k*Tc, (k+1)*Tc)`` past each session's counter offset, so chunked
    and monolithic payloads produce identical streams.  Per round, chunk
    k+1's hop is issued before chunk k's vote (double-buffered)."""
    mcfg = plan.mask_cfg()
    c = plan.cluster_size
    node_ids = tp.node_ids()
    row_seeds = tp.expand(meta.seeds)
    row_offs = tp.expand(meta.offsets)
    K = len(chunks)
    Tc = chunks[0].shape[-1]

    def off(k):
        delta = plan.chunk_offset(k, Tc)
        return row_offs if not delta else narrow(wide(row_offs) + delta)

    # --- Step 1: encrypt (fused clip+quantize+pad, incl. pairwise) ---
    qs = [mask_encrypt_batch_fn(ch, node_ids, row_seeds, mcfg.scale,
                                mcfg.clip, mode=_ENC_MODE[mcfg.mode],
                                offsets=off(k), cluster_size=c, impl=tp.impl)
          for k, ch in enumerate(chunks)]

    # --- Steps 1-2: intra-cluster modular sum (pairwise pads cancel) ---
    accs = [tp.cluster_sum(q) for q in qs]
    del qs

    # --- Step 3: voted schedule; hops pipelined over chunks ---
    locals_ = list(accs)
    for ri, rnd in enumerate(plan.rounds):
        inflight = tp.hop(rnd, ri, meta, accs[0])
        new_accs = []
        for k in range(K):
            nxt = tp.hop(rnd, ri, meta, accs[k + 1]) if k + 1 < K else None
            voted = tp.vote(rnd, inflight, _vote_base(rnd, accs[k],
                                                      locals_[k]))
            new_accs.append(tp.select(rnd, voted, accs[k]))
            inflight = nxt
        accs = new_accs

    # --- Step 4: threshold decryption (fused unmask+dequantize) ---
    if reveal_only:
        accs, row_seeds, row_offs = tp.reveal_rows(accs, meta)
    umode = "mask" if mcfg.mode == "global" else "dequantize"
    return [unmask_decrypt_batch_fn(a, mcfg.n_nodes, row_seeds, mcfg.scale,
                                    mode=umode, offsets=off(k), impl=tp.impl)
            for k, a in enumerate(accs)]


# ---------------------------------------------------------------------------
# Pytree payloads: pack leaves into fixed-size chunks (no giant concat)
# ---------------------------------------------------------------------------


def pack_chunks(leaves: list, chunk_elems: int) -> list:
    """Flatten leaves into equal chunks of ``chunk_elems`` float32
    elements (last chunk zero-padded)."""
    pieces = [l.reshape(-1).to(torch.float32) for l in leaves
              if l.numel() > 0]
    total = sum(p.shape[0] for p in pieces)
    chunk_elems = min(chunk_elems, total)
    chunks, cur, cur_n = [], [], 0
    for p in pieces:
        pos = 0
        while pos < p.shape[0]:
            take = min(chunk_elems - cur_n, p.shape[0] - pos)
            cur.append(p[pos:pos + take])
            cur_n += take
            pos += take
            if cur_n == chunk_elems:
                chunks.append(cur[0] if len(cur) == 1 else torch.cat(cur))
                cur, cur_n = [], 0
    if cur_n:
        cur.append(cur[0].new_zeros((chunk_elems - cur_n,)))
        chunks.append(torch.cat(cur))
    return chunks


def unpack_chunks(chunks: list, leaves: list) -> list:
    """Inverse of ``pack_chunks``: re-slice summed chunks into leaves.
    Each entry of the list ``chunks`` is set to None once every leaf that
    reads it is built, so a caller holding no other reference keeps the
    summed chunks and one leaf's copy at the peak, not two copies of the
    tree."""
    size, dev = chunks[0].shape[0], chunks[0].device
    outs, off = [], 0
    for l in leaves:
        if l.numel() == 0:
            outs.append(torch.zeros(l.shape, dtype=l.dtype, device=dev))
            continue
        need, parts = l.numel(), []
        while need:
            k, j = divmod(off, size)
            take = min(need, size - j)
            parts.append(chunks[k][j:j + take])
            off += take
            need -= take
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        outs.append(flat.reshape(l.shape).to(l.dtype))
        del parts, flat
        for k in range(off // size):
            chunks[k] = None
    return outs


# ---------------------------------------------------------------------------
# Simulation transport: node axis explicit, hops are gathers
# ---------------------------------------------------------------------------


class RoundIndex:
    """The gather maps of a plan's rounds as index tensors on one device,
    built once per distinct round: the (r, n) copy-stream sources, the
    (n,) backup sources and the (1, n, 1) participation mask."""

    def __init__(self, plan: AggPlan, device: torch.device):
        self.device = device
        self._maps = {}
        for rnd in plan.rounds:
            if rnd in self._maps:      # e.g. the ring's g - 1 equal rounds
                continue
            self._maps[rnd] = (
                torch.tensor(rnd.src_idx, dtype=torch.int64, device=device),
                torch.tensor(rnd.backup_src, dtype=torch.int64,
                             device=device),
                torch.tensor(rnd.participates, dtype=torch.bool,
                             device=device)[None, :, None])

    def src(self, rnd: HopRound, stream: int) -> torch.Tensor:
        return self._maps[rnd][0][stream]

    def backup(self, rnd: HopRound) -> torch.Tensor:
        return self._maps[rnd][1]

    def part(self, rnd: HopRound) -> torch.Tensor:
        return self._maps[rnd][2]


class SimTransport(Transport):
    """Single-device oracle over (S * n, T) rows, row = s * n + node."""

    def __init__(self, plan: AggPlan, S: int = 1,
                 impl: Optional[str] = None, *, device,
                 index: Optional[RoundIndex] = None):
        self.plan = plan
        self.S = S
        self.bytes_sent = 0
        self._static_faults = None
        self.impl = impl if impl is not None else plan.cfg.kernel_impl
        backend.check_impl(self.impl)
        self.device = torch.device(device)
        self.index = index if index is not None else RoundIndex(plan,
                                                                self.device)

    def _3d(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.S, self.plan.n_nodes, x.shape[-1])

    def node_ids(self) -> torch.Tensor:
        return torch.arange(self.plan.n_nodes, dtype=torch.int32,
                            device=self.device).repeat(self.S)

    def expand(self, per_session: torch.Tensor) -> torch.Tensor:
        return per_session.to(self.device).repeat_interleave(
            self.plan.n_nodes)

    def cluster_sum(self, q: torch.Tensor) -> torch.Tensor:
        """Sum each cluster's c rows mod 2^32 (an int64 sum, then masked)
        and hand the sum to every member."""
        S, g, c = self.S, self.plan.cfg.n_clusters, self.plan.cluster_size
        T = q.shape[-1]
        acc = narrow(q.reshape(S, g, c, T).sum(dim=2, dtype=torch.int64))
        return acc[:, :, None].expand(S, g, c, T).reshape(q.shape)

    # wire view: (S, n, T) with the node axis explicit
    def _wire(self, acc: torch.Tensor) -> torch.Tensor:
        return self._3d(acc)

    def _sel(self, m: torch.Tensor) -> torch.Tensor:
        if m.dim() == 1:
            m = m[None]
        return m[:, :, None]                    # (., n, 1)

    def _digest(self, x3: torch.Tensor) -> torch.Tensor:
        S, n = self.S, self.plan.n_nodes
        dg = digest_rows(x3.reshape(S * n, -1), self.plan.cfg.digest_words)
        return dg.reshape(S, n, -1)

    def _gather(self, x3: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        out = x3.index_select(1, src)
        return out.reshape(out.shape[0] * out.shape[1], out.shape[2])

    def _move(self, rnd: HopRound, stream: int, x: torch.Tensor
              ) -> torch.Tensor:
        return self._gather(x, self.index.src(rnd, stream))

    def _move_backup(self, rnd: HopRound, x: torch.Tensor) -> torch.Tensor:
        return self._gather(x, self.index.backup(rnd))

    def select(self, rnd: HopRound, voted: torch.Tensor,
               acc: torch.Tensor) -> torch.Tensor:
        part = self.index.part(rnd)
        return torch.where(part, self._3d(voted), self._3d(acc)
                           ).reshape(acc.shape)

    def reveal_rows(self, accs: list, meta: SessionMeta):
        # every cluster member holds the identical aggregate: reveal
        # member 0's copy per session
        return ([self._3d(a)[:, 0].contiguous() for a in accs],
                meta.seeds, meta.offsets)


def sim_batch(plan: AggPlan, xs: torch.Tensor, meta: SessionMeta, *,
              reveal_only: bool = False, impl: Optional[str] = None,
              index: Optional[RoundIndex] = None):
    """Single-device oracle run: (S, n_nodes, T) per-session / per-node
    payloads -> ((S, n_nodes, T) per-node results -- or (S, T) with
    ``reveal_only`` --, the SimTransport, whose ``bytes_sent`` carries
    the hop bandwidth account).  Runs on ``xs``'s device."""
    S, n, T = xs.shape
    if n != plan.n_nodes:
        raise ValueError(f"xs has {n} nodes, plan {plan.n_nodes}")
    tp = SimTransport(plan, S=S, impl=impl, device=xs.device, index=index)
    flat = xs.reshape(S * n, T).to(torch.float32).contiguous()
    (out,) = execute_chunks(plan, tp, [flat], meta, reveal_only=reveal_only)
    return out.reshape((S, T) if reveal_only else (S, n, T)), tp


def build_batch_executable(plan: AggPlan, *, backend: str = "sim",
                           mesh=None, dp_axes: Sequence[str] = ("data",),
                           impl: Optional[str] = None, device=None,
                           index: Optional[RoundIndex] = None):
    """The batch-reveal callable the facade's batched one-shot uses:

        fn(xs, seeds, offsets, fault_masks) -> (S, T) revealed rows

    with ``xs`` (S, n, T) per-session / per-node payloads on ``device``,
    for any S and T.  ``backend`` picks the substrate: the sim oracle
    (its round index tensors are ``index`` or built once, here) or a
    :class:`MeshTransport` over ``mesh`` with the distributed reveal.
    ``fn.last_bytes`` holds the executed wire bytes of the latest call,
    ``fn.last_wire_s`` its staging and transfer seconds by kind (zeros
    on the sim)."""
    if backend == "mesh":
        mt = MeshTransport(mesh, dp_axes, impl=impl)

        def fn(xs, seeds, offsets, fault_masks):
            meta = SessionMeta(seeds=seeds, offsets=offsets,
                               fault_masks=dict(fault_masks))
            out = mt.execute(plan, xs, meta, reveal_only=True)
            fn.last_bytes, fn.last_wire_s = mt.last_bytes, mt.last_wire_s
            return out
    elif backend == "sim":
        if index is None:
            index = RoundIndex(plan, torch.device(device))

        def fn(xs, seeds, offsets, fault_masks):
            meta = SessionMeta(seeds=seeds, offsets=offsets,
                               fault_masks=dict(fault_masks))
            out, tp = sim_batch(plan, xs, meta, reveal_only=True, impl=impl,
                                index=index)
            fn.last_bytes, fn.last_wire_s = tp.bytes_sent, wire_seconds()
            return out
    else:
        raise ValueError(f"backend={backend!r}: pick 'sim' or 'mesh'")

    fn.last_bytes = fn.last_wire_s = None
    return fn


# ---------------------------------------------------------------------------
# Rank-local payloads: one rank per protocol node
# ---------------------------------------------------------------------------


def tree_flatten(tree):
    """A tensor or a dict / list / tuple of them -> (leaves, rebuild).
    Dict keys are taken in sorted order, as the reference flattens them,
    so the leaves concatenate in the same order on both sides."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [tree_flatten(v) for v in tree]
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


def manual_allreduce(x: torch.Tensor, cfg, mesh,
                     dp_axes: Sequence[str] = ("data",)) -> torch.Tensor:
    """Exact-sum allreduce of this rank's ``x`` over the dp axes of
    ``mesh`` via the paper schedule; every rank of the mesh calls it with
    its own value and gets the sum."""
    plan = compile_plan(cfg)
    tp = ManualTransport(plan, mesh, dp_axes, device=x.device)
    flat = x.reshape(-1).to(torch.float32)
    (out,) = execute_chunks(plan, tp, [flat[None]],
                            SessionMeta.single(cfg.seed, device=x.device))
    return out[0].reshape(x.shape)


def tree_allreduce(tree, cfg, mesh, dp_axes: Sequence[str] = ("data",),
                   account: Optional[dict] = None):
    """Apply to a tree of this rank's tensors (a dict / list / tuple).
    Leaves are packed into chunks of ``cfg.chunk_elems`` and the voted
    hops are pipelined over the chunks: chunk k+1's wires are posted
    before chunk k's vote waits on its own.  Where ``account`` is given,
    the run's wire bytes and wire seconds by kind are added to its
    ``"bytes_sent"`` and ``"wire_s"``."""
    leaves, rebuild = tree_flatten(tree)
    chunks = pack_chunks(leaves, cfg.chunk_elems)
    if not chunks:              # every leaf zero-size: nothing to aggregate
        return tree
    plan = compile_plan(cfg)
    dev = chunks[0].device
    tp = ManualTransport(plan, mesh, dp_axes, device=dev,
                         chunks=len(chunks))
    outs = [o[0] for o in execute_chunks(
        plan, tp, [ch[None] for ch in chunks],
        SessionMeta.single(cfg.seed, device=dev))]
    del chunks
    if account is not None:
        account["bytes_sent"] += tp.bytes_sent
        for k, v in tp.link.seconds.items():
            account["wire_s"][k] += v
    return rebuild(unpack_chunks(outs, leaves))


# ---------------------------------------------------------------------------
# Manual transport: one rank of a process group per protocol node
# ---------------------------------------------------------------------------


WIRE_KINDS = ("hop", "cluster", "gather")


def wire_seconds() -> dict:
    """A zeroed per-kind account of wire seconds."""
    return dict.fromkeys(WIRE_KINDS, 0.0)


class _Link:
    """How bits reach the wire.  Gloo's point-to-point ops and
    collectives take host memory, so a CUDA tensor over a gloo group is
    staged through pinned host buffers (device to host, the transfer,
    host to device); a CPU tensor goes as it is.  The choice is read from
    the group's backend.  A CUDA tensor on any other backend (NCCL) is
    refused: one card takes one NCCL rank, so no run has exercised that
    wire yet.  ``seconds`` sums the host time spent staging and waiting
    on transfers, by kind: the hops, the cluster sums and the gathers of
    results."""

    def __init__(self, mesh, device: torch.device):
        self.device = device
        self.stage = device.type == "cuda"
        if self.stage and mesh.backend != "gloo":
            raise ConfigError(
                f"CUDA tensors over a {mesh.backend!r} group: only gloo "
                "(staged through host memory) is supported")
        self.seconds = wire_seconds()

    def put(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """The tensor to hand to ``torch.distributed`` for ``x``."""
        if not self.stage:
            return x.contiguous()
        torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        self.seconds[kind] += time.perf_counter() - t0
        return h

    def zeros(self, like: torch.Tensor) -> torch.Tensor:
        """A zeroed receive buffer shaped as ``like``, on the wire's side."""
        if not self.stage:
            return torch.zeros_like(like)
        return torch.zeros(like.shape, dtype=like.dtype, pin_memory=True)

    def empty(self, like: torch.Tensor) -> torch.Tensor:
        """A buffer the transfer fills whole, on the wire's side."""
        if not self.stage:
            return torch.empty_like(like)
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def take(self, h: torch.Tensor, kind: str,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A received wire tensor back on the run's device (into ``out``
        where given)."""
        if not self.stage:
            return h if out is None else out.copy_(h)
        t0 = time.perf_counter()
        out = h.to(self.device) if out is None else out.copy_(h)
        self.seconds[kind] += time.perf_counter() - t0
        return out

    def wait(self, works, kind: str) -> None:
        t0 = time.perf_counter()
        for w in works:
            w.wait()
        self.seconds[kind] += time.perf_counter() - t0


def plan_wires(plan: AggPlan) -> int:
    """Wires one chunk of ``plan`` posts per rank: r payload copies a
    round on the full transport; one payload, r digests and the backup
    on the digest transport."""
    cfg = plan.cfg
    per_round = (cfg.redundancy if cfg.transport == "full"
                 else 1 + cfg.redundancy + int(cfg.digest_backup))
    return per_round * len(plan.rounds)


def _pair_of(perm, nid: int) -> tuple:
    """(node ``nid`` sends to, ``nid`` receives from) in one copy stream,
    None where it does not.  Each stream is a partial permutation --
    each source and each destination at most once -- as ``ppermute``
    requires in the reference."""
    srcs, dsts = [p[0] for p in perm], [p[1] for p in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"copy stream {perm} is not a partial permutation")
    send_to = next((d for s, d in perm if s == nid), None)
    recv_from = next((s for s, d in perm if d == nid), None)
    return send_to, recv_from


class ManualTransport(Transport):
    """This rank's (S, T) rows, one rank per protocol node of ``mesh``
    (node id ``flat_node_id`` over ``dp_axes``): hops are paired
    ``isend`` / ``irecv``, the intra-cluster sum an ``all_reduce`` on the
    rank's cluster group, the distributed reveal an ``all_gather``.

    Every rank runs the same engine code over the same plan, so every
    rank makes the same wires in the same order; a wire's tag is its
    sequence number in this transport's run, past a base the mesh
    reserves for the transport (``NodeMesh.reserve_tags``: the plan's
    wires for ``chunks`` chunks).  That gives each wire its own tag --
    payload stream s, digest stream s, the backup and the chunk -- which
    matters where two of them share a (src, dst) pair and are in flight
    at once: digest stream 1 and the backup stream (both shift 1), or
    the hops of chunks k and k+1.  The base never repeats on a mesh, so
    a retried run cannot receive a wire that a failed run posted and
    left unmatched.  ``hop`` posts a round's
    wires and returns them with the copies they fill; ``vote`` waits on
    the wires it is handed before it reads a received buffer, so a
    wrapper (``MeshTransport.wrap_inner``) may hold, reorder or re-issue
    hops.  A wire made outside ``hop`` is waited on at once.  The shared
    ``Transport._account`` counts the whole plan's wire bytes from its
    pair lists, so every rank's ``bytes_sent`` equals the sim's account,
    which equals ``schedules.schedule_cost``."""

    def __init__(self, plan: AggPlan, mesh, dp_axes: Sequence[str] = ("data",),
                 S: int = 1, impl: Optional[str] = None,
                 shard_reveal: bool = False, *, device, chunks: int = 1):
        self.plan = plan
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes)
        self.S = S
        self.bytes_sent = 0
        self._static_faults = None
        self.impl = impl if impl is not None else plan.cfg.kernel_impl
        backend.check_impl(self.impl)
        self.device = torch.device(device)
        # distributed reveal: each rank decrypts only its 1/n slice of the
        # revealed sessions (see ``reveal_rows``) instead of all S
        self.shard_reveal = shard_reveal
        for ax in self.dp_axes:
            if ax not in mesh.shape:
                raise ConfigError(f"dp axis {ax!r} is not a mesh axis "
                                  f"{mesh.axis_names}")
        self.node_id = flat_node_id(mesh, self.dp_axes)
        self._ranks = ranks_by_node(mesh, self.dp_axes,
                                     slice_of(mesh, self.dp_axes, mesh.rank))
        if len(self._ranks) != plan.n_nodes:
            raise ConfigError(
                f"the plan has {plan.n_nodes} nodes, the mesh's dp axes "
                f"{self.dp_axes} hold {len(self._ranks)} ranks")
        self._pairs = {}
        for rnd in plan.rounds:
            if rnd not in self._pairs:
                self._pairs[rnd] = (
                    [_pair_of(p, self.node_id) for p in rnd.perms],
                    _pair_of(rnd.backup_perm, self.node_id),
                    rnd.participates[self.node_id])
        self.link = _Link(mesh, self.device)
        self._tags = plan_wires(plan) * chunks
        self._tag0 = mesh.reserve_tags(self._tags)
        self._tag = 0
        self._wires = None          # the wires of the hop being posted

    def node_ids(self) -> torch.Tensor:
        return torch.full((self.S,), self.node_id, dtype=torch.int32,
                          device=self.device)

    def expand(self, per_session: torch.Tensor) -> torch.Tensor:
        return per_session.to(self.device)

    def cluster_sum(self, q: torch.Tensor) -> torch.Tensor:
        """All-reduce on the rank's cluster group.  The sum of int32 words
        wraps mod 2^32, which is the ring's sum."""
        if self.plan.cluster_size == 1:
            return q
        group, _ = subgroup(self.mesh, self.dp_axes, self.plan.groups)
        t = self.link.put(q, "cluster")
        self.link.wait([dist.all_reduce(t, op=dist.ReduceOp.SUM,
                                        group=group, async_op=True)],
                       "cluster")
        return self.link.take(t, "cluster")

    # wire view: this rank's (S, T) rows; hops are point-to-point
    def _sel(self, m: torch.Tensor) -> torch.Tensor:
        if m.dim() == 1:
            return m[self.node_id].reshape(1, 1).expand(self.S, 1)
        return m[:, self.node_id][:, None]      # (S, 1) this rank's column

    def _digest(self, x: torch.Tensor) -> torch.Tensor:
        return digest_rows(x, self.plan.cfg.digest_words)

    def _exchange(self, x: torch.Tensor, pair: tuple) -> torch.Tensor:
        send_to, recv_from = pair
        if self._tag >= self._tags:
            raise ConfigError(
                f"wire {self._tag} past the {self._tags} tags reserved for "
                "this transport: pass chunks= for every chunk it runs")
        tag = (self._tag0 + self._tag) % TAG_SPACE
        self._tag += 1
        if send_to == self.node_id:
            # a self-pair (src == dst): no schedule compiles one today,
            # and a send to one's own rank raises, so it is a local copy
            return x.clone()
        # ppermute zero-fills: a rank that is no pair's destination
        # receives zeros (tree rounds have such ranks)
        out = torch.zeros_like(x)
        ops, sent, buf = [], None, None
        if send_to is not None:
            sent = self.link.put(x, "hop")
            ops.append(dist.P2POp(dist.isend, sent, self._ranks[send_to],
                                  tag=tag))
        if recv_from is not None:
            buf = self.link.zeros(x) if self.link.stage else out
            ops.append(dist.P2POp(dist.irecv, buf, self._ranks[recv_from],
                                  tag=tag))
        if ops:
            wire = (dist.batch_isend_irecv(ops), sent, buf, out)
            if self._wires is None:
                self._land([wire])
            else:
                self._wires.append(wire)
        return out

    def _land(self, wires: list) -> None:
        """Wait on ``wires`` and bring staged receives to their outputs."""
        for works, _sent, buf, out in wires:
            self.link.wait(works, "hop")
            if buf is not None and buf is not out:
                self.link.take(buf, "hop", out)

    def _move(self, rnd: HopRound, stream: int, x: torch.Tensor
              ) -> torch.Tensor:
        return self._exchange(x, self._pairs[rnd][0][stream])

    def _move_backup(self, rnd: HopRound, x: torch.Tensor) -> torch.Tensor:
        return self._exchange(x, self._pairs[rnd][1])

    def hop(self, rnd: HopRound, rnd_idx: int, meta: SessionMeta,
            acc: torch.Tensor):
        """(the round's posted wires, the copies they fill)."""
        self._wires = []
        copies = super().hop(rnd, rnd_idx, meta, acc)
        wires, self._wires = self._wires, None
        return wires, copies

    def vote(self, rnd: HopRound, inflight, base: torch.Tensor
             ) -> torch.Tensor:
        wires, copies = inflight
        self._land(wires)
        return super().vote(rnd, copies, base)

    def select(self, rnd: HopRound, voted: torch.Tensor,
               acc: torch.Tensor) -> torch.Tensor:
        return voted if self._pairs[rnd][2] else acc

    def reveal_rows(self, accs: list, meta: SessionMeta):
        seeds = self.expand(meta.seeds)
        offs = self.expand(meta.offsets)
        if not self.shard_reveal:
            # every rank decrypts its own (identical) copy
            return accs, seeds, offs
        # Distributed reveal: after the voted rounds every rank holds the
        # identical (S, T) aggregate, so each rank decrypts only rows
        # [nid*S_loc, (nid+1)*S_loc) of the zero-padded sessions, with
        # the matching seed / offset slice; ``gather`` concatenates the
        # slices back and the caller drops the padding past S.
        n = self.plan.n_nodes
        s_loc = -(-self.S // n)
        pad = n * s_loc - self.S
        start = self.node_id * s_loc

        def sl(a):
            if pad:
                a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
            return a[start:start + s_loc].contiguous()

        return [sl(a) for a in accs], sl(seeds), sl(offs)

    def gather(self, x: torch.Tensor) -> list:
        """Every node's ``x`` (equal shapes), in node order, on every rank
        of the dp slice."""
        n = self.plan.n_nodes
        group, members = subgroup(self.mesh, self.dp_axes, [tuple(range(n))])
        t = self.link.put(x, "gather")
        parts = [self.link.empty(x) for _ in members]
        self.link.wait([dist.all_gather(parts, t, group=group,
                                        async_op=True)], "gather")
        return [self.link.take(parts[members.index(self._ranks[i])],
                               "gather") for i in range(n)]


# ---------------------------------------------------------------------------
# Mesh transport: the global batch on every rank, ManualTransport inside
# ---------------------------------------------------------------------------


class MeshTransport:
    """Distributed plan execution: one rank per protocol node.

    Every rank calls ``execute`` with the global (S, n, T) batch and
    runs :class:`ManualTransport` on its own column, as the reference's
    ``shard_map`` in-spec hands each device its slice; the per-node
    results come back to every rank by ``all_gather``.  Bit-identical to
    ``SimTransport`` for the same plan.  ``last_bytes`` holds the inner
    transport's wire account, ``last_wire_s`` its staging and transfer
    seconds by kind (``WIRE_KINDS``), after an ``execute``."""

    def __init__(self, mesh, dp_axes: Sequence[str] = ("data",),
                 impl: Optional[str] = None, wrap_inner=None):
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes)
        self.impl = impl
        # optional hook wrapping the per-rank ManualTransport (e.g. the
        # service's chaos injection); it must keep the Transport protocol,
        # and may hold, reorder or re-issue hops: each hop's value carries
        # the wires its vote waits on
        self.wrap_inner = wrap_inner
        self.last_bytes: Optional[int] = None
        self.last_wire_s: Optional[dict] = None
        n = 1
        for ax in self.dp_axes:
            if ax not in mesh.shape:
                raise ConfigError(f"dp axis {ax!r} is not a mesh axis "
                                  f"{mesh.axis_names}")
            n *= mesh.shape[ax]
        self.n_devices = n

    def execute(self, plan: AggPlan, xs: torch.Tensor, meta: SessionMeta,
                *, reveal_only: bool = False) -> torch.Tensor:
        """xs: (S, n_nodes, T) per-session / per-node payloads on this
        rank's device -> (S, n_nodes, T) per-node results, or (S, T) with
        ``reveal_only`` (the distributed reveal: each rank decrypts its
        1/n slice of the sessions and the slices are gathered)."""
        S, n, T = xs.shape
        if not n == plan.n_nodes == self.n_devices:
            raise ValueError(f"xs has {n} nodes, the plan "
                             f"{plan.n_nodes}, the mesh {self.n_devices}")
        tp = ManualTransport(plan, self.mesh, self.dp_axes, S=S,
                             impl=self.impl, shard_reveal=reveal_only,
                             device=xs.device)
        run_tp = tp if self.wrap_inner is None else self.wrap_inner(tp)
        xl = xs[:, tp.node_id, :].to(torch.float32).contiguous()
        (out,) = execute_chunks(plan, run_tp, [xl], meta,
                                reveal_only=reveal_only)
        parts = tp.gather(out)
        self.last_bytes = tp.bytes_sent
        self.last_wire_s = dict(tp.link.seconds)
        if reveal_only:
            return torch.cat(parts)[:S]
        return torch.stack(parts, dim=1)
