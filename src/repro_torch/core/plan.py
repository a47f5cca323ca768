"""Config model + plan compiler for the secure-allreduce protocol core.

Counterpart of ``repro/core/plan.py``.  One run is described by four
frozen sections -- :class:`Topology` (who aggregates), :class:`Security`
(voting, masking, fault model), :class:`Wire` (what the hops ship) and
:class:`Runtime` (where it executes) -- that compose into the flat,
hashable :class:`AggConfig`.  Invalid knobs raise :class:`ConfigError`.

``compile_plan`` turns a config into an :class:`AggPlan`, memoised per
config: the voted schedule as explicit :class:`HopRound`\\ s (pair lists
and gather maps per redundant copy stream, the participation mask, the
digest transport's shift-1 backup stream), the intra-cluster groups and
the static fault model.  Everything per session (pad keys, counter
offsets, runtime fault masks) rides in :class:`SessionMeta` as tensors.

The secure-function plans (``FuncPlan``) come with the funcs slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import schedules as SCH
from repro_torch.core.byzantine import ByzantineSpec
from repro_torch.core.masking import MaskConfig
from repro_torch.kernels.backend import IMPLS
from repro_torch.kernels.secure_agg.secure_agg import M32

_DEFAULT_SEED = 0x5EC0A66

ConfigError = SCH.ConfigError
_require = SCH._require


@dataclasses.dataclass(frozen=True)
class Topology:
    """Who aggregates: the committee layout of one protocol run."""
    n_nodes: int                  # total nodes (g * c)
    cluster_size: int = 4         # c  (paper: O(log n))
    schedule: str = "ring"        # ring | tree | butterfly

    def __post_init__(self):
        _require(self.n_nodes >= 1,
                 f"n_nodes must be >= 1, got {self.n_nodes}")
        _require(self.cluster_size >= 1,
                 f"cluster_size must be >= 1, got {self.cluster_size}")
        _require(self.n_nodes % self.cluster_size == 0,
                 f"n_nodes={self.n_nodes} must be a multiple of "
                 f"cluster_size={self.cluster_size} (clusters are "
                 "contiguous rank groups); pick a dividing cluster_size "
                 "or use cfg.derive(n_nodes=...) to reclamp")
        _require(self.schedule in SCH.SCHEDULES,
                 f"unknown schedule {self.schedule!r}; pick one of "
                 f"{sorted(SCH.SCHEDULES)}")
        g = self.n_nodes // self.cluster_size
        _require(self.schedule not in ("tree", "butterfly") or g == 1
                 or g & (g - 1) == 0,
                 f"schedule={self.schedule!r} needs a power-of-two "
                 f"cluster count, got g={g} (= n_nodes/cluster_size); "
                 "use 'ring', or adjust the committee shape")

    @property
    def n_clusters(self) -> int:
        return self.n_nodes // self.cluster_size


@dataclasses.dataclass(frozen=True)
class Security:
    """What the protocol defends: voting, masking, the fault model."""
    redundancy: int = 3           # r odd: copies per vote
    masking: str = "global"       # global | pairwise | none
    clip: float = 1.0             # quantization range [-clip, clip]
    guard_bits: int = 2           # summation headroom beyond ceil(log2 n)
    seed: int = _DEFAULT_SEED     # pad-stream base key
    byzantine: ByzantineSpec = ByzantineSpec()

    def __post_init__(self):
        _require(self.redundancy >= 1,
                 f"redundancy must be >= 1, got {self.redundancy}")
        _require(self.redundancy % 2 == 1,
                 f"redundancy={self.redundancy} must be odd — the "
                 "element-wise majority vote needs an unambiguous median")
        _require(self.masking in ("global", "pairwise", "none"),
                 f"unknown masking {self.masking!r}; pick one of "
                 "['global', 'pairwise', 'none']")
        _require(self.clip > 0,
                 f"clip must be > 0 (quantization range), got {self.clip}")
        _require(self.guard_bits >= 0,
                 f"guard_bits must be >= 0, got {self.guard_bits}")


@dataclasses.dataclass(frozen=True)
class Wire:
    """What the voted hops ship over the wire."""
    transport: str = "full"       # full | digest
    digest_words: int = 16        # words per row digest (digest transport)
    # digest transport: ship the shift-1 full-payload backup stream
    # eagerly, so a digest-rejected payload is replaced in the same pass
    digest_backup: bool = True
    # payloads are packed into equal chunks of this many float32 elements
    chunk_elems: int = 1 << 16

    def __post_init__(self):
        _require(self.transport in ("full", "digest"),
                 f"unknown transport {self.transport!r}; pick 'full' "
                 "(r payload copies per hop) or 'digest' (1 payload + "
                 "r digests)")
        _require(self.transport != "digest" or self.digest_words >= 1,
                 f"transport='digest' needs digest_words >= 1 (got "
                 f"{self.digest_words}) — zero-width digests cannot "
                 "vote; use transport='full' if you want no digests")
        _require(self.chunk_elems >= 1,
                 f"chunk_elems must be >= 1, got {self.chunk_elems}")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Where the protocol executes (facade-level; never part of a plan).

    ``kernel_impl``: ``None`` (the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors), ``"cuda"`` or ``"torch"`` (the plain
    versions on any device).  ``backend`` picks the engine transport the
    one-shot facade verbs run on: ``"sim"`` (single-device oracle),
    ``"manual"`` (each rank of a process group passes its own value;
    ``mesh`` or, without one, the ``node_mesh`` of the group), ``"mesh"``
    (every rank passes the global batch; needs ``mesh``), or ``"auto"``
    (mesh when one is given, sim otherwise).  ``mesh`` is a
    :class:`~repro_torch.runtime.compat.NodeMesh`."""
    kernel_impl: Optional[str] = None   # None | cuda | torch
    backend: str = "auto"               # auto | sim | manual | mesh
    mesh: Optional[object] = None       # NodeMesh for "mesh" / "manual"
    dp_axes: tuple = ("data",)

    def __post_init__(self):
        _require(self.backend in ("auto", "sim", "manual", "mesh"),
                 f"unknown backend {self.backend!r}; pick one of "
                 "['auto', 'sim', 'manual', 'mesh']")
        _require(self.kernel_impl in IMPLS,
                 f"unknown kernel_impl {self.kernel_impl!r}; pick one of "
                 f"{list(IMPLS)}")
        _require(self.backend != "mesh" or self.mesh is not None,
                 "backend='mesh' needs a mesh: pass "
                 "Runtime(backend='mesh', mesh=compat.node_mesh(n))")
        object.__setattr__(self, "dp_axes", tuple(self.dp_axes))

    def resolve(self) -> str:
        """The effective backend ('auto' resolved)."""
        if self.backend != "auto":
            return self.backend
        return "mesh" if self.mesh is not None else "sim"


@dataclasses.dataclass(frozen=True)
class AggConfig:
    """Flat, hashable protocol config the plan compiler consumes (the
    plan-cache key); the sections come back as ``.topology`` /
    ``.security`` / ``.wire``."""
    n_nodes: int
    cluster_size: int = 4
    redundancy: int = 3
    schedule: str = "ring"
    transport: str = "full"
    digest_words: int = 16
    digest_backup: bool = True
    masking: str = "global"
    clip: float = 1.0
    guard_bits: int = 2
    seed: int = _DEFAULT_SEED
    byzantine: ByzantineSpec = ByzantineSpec()
    chunk_elems: int = 1 << 16
    kernel_impl: Optional[str] = None     # None | cuda | torch

    def __post_init__(self):
        self.topology, self.security, self.wire  # noqa: B018
        _require(self.kernel_impl in IMPLS,
                 f"unknown kernel_impl {self.kernel_impl!r}")
        # a vote's r copies come from distinct members of one cluster
        _require(self.redundancy <= self.cluster_size,
                 f"redundancy={self.redundancy} > cluster_size="
                 f"{self.cluster_size}: the r redundant copies are "
                 "distinct member shifts within one cluster; lower "
                 "redundancy or grow the cluster")

    @property
    def topology(self) -> Topology:
        return Topology(n_nodes=self.n_nodes, cluster_size=self.cluster_size,
                        schedule=self.schedule)

    @property
    def security(self) -> Security:
        return Security(redundancy=self.redundancy, masking=self.masking,
                        clip=self.clip, guard_bits=self.guard_bits,
                        seed=self.seed, byzantine=self.byzantine)

    @property
    def wire(self) -> Wire:
        return Wire(transport=self.transport, digest_words=self.digest_words,
                    digest_backup=self.digest_backup,
                    chunk_elems=self.chunk_elems)

    @classmethod
    def compose(cls, topology: Topology, security: Security = Security(),
                wire: Wire = Wire(),
                runtime: Optional[Runtime] = None) -> "AggConfig":
        """The config sections -> one flat config; only
        ``runtime.kernel_impl`` rides along."""
        return cls(
            n_nodes=topology.n_nodes, cluster_size=topology.cluster_size,
            schedule=topology.schedule,
            redundancy=security.redundancy, masking=security.masking,
            clip=security.clip, guard_bits=security.guard_bits,
            seed=security.seed, byzantine=security.byzantine,
            transport=wire.transport, digest_words=wire.digest_words,
            digest_backup=wire.digest_backup, chunk_elems=wire.chunk_elems,
            kernel_impl=runtime.kernel_impl if runtime is not None else None)

    def replace(self, **kw) -> "AggConfig":
        """Validated ``dataclasses.replace`` accepting flat knobs and/or
        whole sections; explicit flat knobs win over section fields."""
        base = {}
        for name in ("topology", "security", "wire"):
            sec = kw.pop(name, None)
            if sec is not None:
                for f in dataclasses.fields(sec):
                    base[f.name] = getattr(sec, f.name)
        base.update(kw)
        return dataclasses.replace(self, **base)

    def derive(self, **kw) -> "AggConfig":
        """Override that reclamps the committee shape: a smaller
        ``n_nodes`` pulls ``cluster_size`` down to the largest divisor and
        ``redundancy`` to the largest odd value that fits, and drops
        static Byzantine ranks out of range."""
        if "n_nodes" in kw:
            n = kw["n_nodes"]
            _require(n >= 1, f"n_nodes must be >= 1, got {n}")
            c = kw.get("cluster_size", min(self.cluster_size, n))
            if "cluster_size" not in kw:
                while n % c:
                    c -= 1
                kw["cluster_size"] = c
            if "redundancy" not in kw:
                r = min(self.redundancy, c)
                kw["redundancy"] = max(r - (1 - r % 2), 1)
            if "byzantine" not in kw and self.byzantine.corrupt_ranks:
                keep = tuple(x for x in self.byzantine.corrupt_ranks
                             if x < n)
                kw["byzantine"] = dataclasses.replace(
                    self.byzantine, corrupt_ranks=keep)
        return self.replace(**kw)

    @property
    def n_clusters(self) -> int:
        return self.n_nodes // self.cluster_size

    def mask_cfg(self) -> MaskConfig:
        return MaskConfig(n_nodes=self.n_nodes, clip=self.clip,
                          guard_bits=self.guard_bits, mode=self.masking,
                          cluster_size=self.cluster_size, seed=self.seed)


# ---------------------------------------------------------------------------
# Static round layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HopRound:
    """One voted schedule round resolved to node granularity:
    ``perms[s]`` are the (src, dst) pairs of copy stream s,
    ``src_idx[s][dst]`` the same map as a gather, ``participates[i]``
    whether node i receives, ``backup_perm``/``backup_src`` the shift-1
    backup stream of the digest transport."""
    combine: str                                      # add|local_plus|replace
    recv_from: tuple[Optional[int], ...]              # cluster-level round
    perms: tuple[tuple[tuple[int, int], ...], ...]    # (r, pairs)
    src_idx: tuple[tuple[int, ...], ...]              # (r, n)
    participates: tuple[bool, ...]                    # (n,)
    backup_perm: tuple[tuple[int, int], ...]          # digest fallback hops
    backup_src: tuple[int, ...]                       # (n,) gather dual


def _hop_perm(n_clusters: int, cluster_size: int,
              recv_from: Sequence[Optional[int]],
              shift: int) -> list[tuple[int, int]]:
    """Pairs of one redundant copy stream: receiver (cl, m) receives from
    (recv_from[cl], (m + shift) % c)."""
    c = cluster_size
    perm = []
    for cl in range(n_clusters):
        src_cl = recv_from[cl]
        if src_cl is None:
            continue
        for m in range(c):
            perm.append((src_cl * c + (m + shift) % c, cl * c + m))
    return perm


# ---------------------------------------------------------------------------
# Per-session runtime metadata
# ---------------------------------------------------------------------------


def fault_masks_of(faults: Sequence[Sequence[ByzantineSpec]],
                   n_nodes: int) -> dict[str, np.ndarray]:
    """Per-session fault specs -> {mode: (S, n) bool mask} (numpy)."""
    masks: dict[str, np.ndarray] = {}
    for s_idx, specs in enumerate(faults):
        for sp in specs:
            if not sp.corrupt_ranks:
                continue
            m = masks.setdefault(
                sp.mode, np.zeros((len(faults), n_nodes), bool))
            m[s_idx, list(sp.corrupt_ranks)] = True
    return masks


def words(v, device) -> torch.Tensor:
    """uint32 values (ints, numpy, or int32-word tensor) -> 1-D int32
    words on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).reshape(-1)
    a = (np.asarray(v, dtype=np.int64).reshape(-1) & M32).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


@dataclasses.dataclass(frozen=True)
class SessionMeta:
    """Everything per session a plan execution needs at runtime, as
    tensors on the run's device: pad-stream keys, counter offsets (both
    (S,) int32 words) and fault masks (mode -> (S, n) bool)."""
    seeds: torch.Tensor
    offsets: torch.Tensor
    fault_masks: dict = dataclasses.field(default_factory=dict)

    @property
    def S(self) -> int:
        return self.seeds.shape[0]

    @classmethod
    def build(cls, S: int, n_nodes: int, *, device, seed: int = 0,
              seeds=None, offsets=None,
              faults: Optional[Sequence[Sequence[ByzantineSpec]]] = None,
              fault_masks=None) -> "SessionMeta":
        """Default seeds / offsets, and either static per-session
        ``faults`` (lowered to masks here) or ready ``fault_masks``."""
        seeds = words([seed] * S if seeds is None else seeds, device)
        offsets = words([0] * S if offsets is None else offsets, device)
        if fault_masks is not None and faults is not None:
            raise ValueError("pass faults or fault_masks, not both")
        if faults is not None:
            if len(faults) != S:
                raise ValueError(f"{len(faults)} fault lists for S={S}")
            fault_masks = fault_masks_of(faults, n_nodes)
        masks = {k: torch.as_tensor(np.asarray(m, bool), device=device)
                 if not isinstance(m, torch.Tensor) else m.to(device)
                 for k, m in (fault_masks or {}).items()}
        return cls(seeds=seeds, offsets=offsets, fault_masks=masks)

    @classmethod
    def single(cls, seed, offset=0, *, device) -> "SessionMeta":
        return cls(seeds=words([seed], device),
                   offsets=words([offset], device))


# ---------------------------------------------------------------------------
# The compiled plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AggPlan:
    """Compiled, transport-independent form of one protocol run."""
    cfg: AggConfig
    groups: tuple[tuple[int, ...], ...]       # intra-cluster sum groups
    rounds: tuple[HopRound, ...]
    faults: tuple[ByzantineSpec, ...]         # static per-run fault model

    @property
    def n_nodes(self) -> int:
        return self.cfg.n_nodes

    @property
    def cluster_size(self) -> int:
        return self.cfg.cluster_size

    @property
    def redundancy(self) -> int:
        return self.cfg.redundancy

    def mask_cfg(self) -> MaskConfig:
        return self.cfg.mask_cfg()

    def chunk_offset(self, chunk_idx: int, chunk_elems: int) -> int:
        """Pad-stream counter offset of chunk k relative to the session
        offset, so chunked streams reproduce the monolithic stream."""
        return chunk_idx * chunk_elems

    def wire_bytes(self, T: int, S: int = 1, chunks: int = 1) -> int:
        """Bytes this plan moves for ``S`` sessions of ``T`` float32
        elements shipped as ``chunks`` equal hops (the digest transport
        ships one digest set per chunk)."""
        total = 0
        for rnd in self.rounds:
            w = hop_wire_words(self.cfg, rnd, T)
            total += w["payload"] + w["backup"] + w["digest"] * chunks
        return 4 * total * S


def hop_wire_words(cfg: AggConfig, rnd: HopRound, T: int) -> dict:
    """uint32 words ONE voted hop of ONE chunk of ``T`` elements moves for
    one session, by wire view -- the single definition of the byte
    account that ``AggPlan.wire_bytes`` and ``Transport._account`` sum."""
    if cfg.transport == "full":
        return {"payload": sum(len(p) for p in rnd.perms) * T,
                "digest": 0, "backup": 0}
    return {"payload": len(rnd.perms[0]) * T,
            "digest": sum(len(p) for p in rnd.perms) * cfg.digest_words,
            "backup": len(rnd.backup_perm) * T if cfg.digest_backup else 0}


_PLAN_CACHE: dict[AggConfig, AggPlan] = {}
_PLAN_STATS = {"hits": 0, "misses": 0}


def plan_cache_stats() -> dict:
    """Hit/miss/size counters of the shared ``compile_plan`` memo."""
    return dict(_PLAN_STATS, size=len(_PLAN_CACHE))


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _PLAN_STATS.update(hits=0, misses=0)


def compile_plan(cfg: AggConfig, *, epoch=None, fault=None) -> AggPlan:
    """AggConfig + overlay snapshot + fault plan -> executable AggPlan,
    memoised per config when neither of the two is given.

    ``epoch`` (optional): an object with ``n_nodes`` / ``cluster_size``
    (e.g. ``service.epochs.EpochSnapshot``) pinning the committee layout
    this plan aggregates over -- validated against ``cfg``.  ``fault``
    (optional): a ``runtime.fault.SessionFaultPlan`` whose crash /
    Byzantine slots are folded into the plan's static fault model (the
    service instead passes *runtime* masks via :class:`SessionMeta`)."""
    cacheable = epoch is None and fault is None
    if cacheable:
        hit = _PLAN_CACHE.get(cfg)
        if hit is not None:
            _PLAN_STATS["hits"] += 1
            return hit
        _PLAN_STATS["misses"] += 1
    n, c, g, r = cfg.n_nodes, cfg.cluster_size, cfg.n_clusters, cfg.redundancy
    if epoch is not None:
        assert epoch.n_nodes == n, (epoch.n_nodes, n)
        assert epoch.cluster_size == c, (epoch.cluster_size, c)

    rounds = []
    for rnd in SCH.get_schedule(cfg.schedule, g):
        perms = tuple(tuple(_hop_perm(g, c, rnd.recv_from, s))
                      for s in range(r))
        src_idx = np.arange(n)[None, :].repeat(r, axis=0)
        backup_src = np.arange(n)
        participates = np.zeros((n,), bool)
        for cl, src_cl in enumerate(rnd.recv_from):
            if src_cl is None:
                continue
            for m in range(c):
                dst = cl * c + m
                participates[dst] = True
                for s in range(r):
                    src_idx[s, dst] = src_cl * c + (m + s) % c
                backup_src[dst] = src_cl * c + (m + 1) % c
        if not participates.any():
            continue
        rounds.append(HopRound(
            combine=rnd.combine, recv_from=tuple(rnd.recv_from), perms=perms,
            src_idx=tuple(tuple(int(v) for v in row) for row in src_idx),
            participates=tuple(bool(b) for b in participates),
            backup_perm=tuple(_hop_perm(g, c, rnd.recv_from, 1)),
            backup_src=tuple(int(v) for v in backup_src)))

    faults = []
    if cfg.byzantine.corrupt_ranks:
        faults.append(cfg.byzantine)
    if fault is not None:
        faults.extend(fault.specs())
    # a rank may appear under at most one static spec: disjointness keeps
    # the sequential spec application order-independent, so every
    # transport corrupts identically (the bit-equality contract)
    seen: set[int] = set()
    for sp in faults:
        overlap = seen & set(sp.corrupt_ranks)
        assert not overlap, f"rank(s) {sorted(overlap)} in multiple specs"
        seen |= set(sp.corrupt_ranks)

    groups = tuple(tuple(range(cl * c, (cl + 1) * c)) for cl in range(g))
    plan = AggPlan(cfg=cfg, groups=groups, rounds=tuple(rounds),
                   faults=tuple(faults))
    if cacheable:
        _PLAN_CACHE[cfg] = plan
    return plan
