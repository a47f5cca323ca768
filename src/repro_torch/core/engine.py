"""One protocol engine, pluggable transports.

Counterpart of ``repro/core/engine.py``.  ``execute_chunks`` runs a
compiled :class:`~repro_torch.core.plan.AggPlan` stage by stage --
encrypt, intra-cluster sum, voted schedule rounds, threshold decrypt --
against a :class:`Transport`, which only moves bits.  This slice has the
single-device oracle, :class:`SimTransport`: the node axis is explicit
and hops are gathers whose index tensors are built once per round on the
run's device.  The distributed transports come with a later slice.

Values are ``(rows, T)`` tensors with ``rows = S * n``: float32 payloads
in, int32 words (uint32 bits) between stages, float32 out.  The three
tensor stages go through the dispatch ops of ``kernels/secure_agg``, so
on a CUDA tensor they launch the CUDA kernels.  Every hop also feeds
``Transport.bytes_sent``, the bandwidth account that equals
``schedules.schedule_cost``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.byzantine import (digest_rows, digest_vote_combine,
                                        equivocate_digest,
                                        equivocate_payload, parse_mode,
                                        sent_value)
from repro_torch.core.plan import (AggPlan, HopRound, SessionMeta,
                                   hop_wire_words)
from repro_torch.kernels import backend
from repro_torch.kernels.secure_agg import (mask_encrypt_batch_fn,
                                            unmask_decrypt_batch_fn,
                                            vote_combine_batch_fn)
from repro_torch.kernels.secure_agg.secure_agg import narrow, wide

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
    """Inverse of ``pack_chunks``: re-slice summed chunks into leaves."""
    size = chunks[0].shape[0]
    outs, off = [], 0
    for l in leaves:
        if l.numel() == 0:
            outs.append(torch.zeros(l.shape, dtype=l.dtype,
                                    device=chunks[0].device))
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
                           impl: Optional[str] = None, device=None,
                           index: Optional[RoundIndex] = None):
    """The batch-reveal callable the facade's batched one-shot uses:

        fn(xs, seeds, offsets, fault_masks) -> (S, T) revealed rows

    with ``xs`` (S, n, T) per-session / per-node payloads on ``device``,
    for any S and T.  The round index tensors are ``index`` or built
    once, here.  ``fn.last_bytes`` holds the executed wire bytes of the
    latest call."""
    if backend != "sim":
        raise ValueError(f"backend={backend!r}: only the 'sim' oracle is "
                         "ported; the mesh transport comes with the "
                         "distributed slice")
    if index is None:
        index = RoundIndex(plan, torch.device(device))

    def fn(xs, seeds, offsets, fault_masks):
        meta = SessionMeta(seeds=seeds, offsets=offsets,
                           fault_masks=dict(fault_masks))
        out, tp = sim_batch(plan, xs, meta, reveal_only=True, impl=impl,
                            index=index)
        fn.last_bytes = tp.bytes_sent
        return out

    fn.last_bytes = None
    return fn
