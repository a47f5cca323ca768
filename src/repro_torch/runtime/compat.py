"""Process bootstrap of the distributed transports.

Counterpart of ``repro/runtime/compat.py``.  In the reference a protocol
node is one device of a ``jax.sharding.Mesh`` inside one process; here it
is one process of a ``torch.distributed`` group.  :class:`NodeMesh` is the
port's mesh: the shape and axis names, each rank's coordinates (row-major
over the axes, as ``jax.make_mesh`` lays out host devices) and the
process group.  ``groups`` caches the subgroups the transports build
on it (``core/engine.py``), since building one is collective.

    spawn_nodes(fn, 8, *args)          # fn(rank, *args) in 8 processes
    mesh = node_mesh(8)                # inside fn: the ("data",) mesh

The group is started from a ``FileStore`` (no TCP port to pick).  Every
mesh needs its world size to equal its shape: a wrong size raises
:class:`ConfigError`, and nothing falls back to the single-device oracle.
"""
from __future__ import annotations

import datetime
import math
import os
import shutil
import sys
import tempfile
import traceback
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.schedules import ConfigError

DEFAULT_TIMEOUT_S = 300.0
# point-to-point tags are C ints on the gloo side: the wire tags of a mesh
# run through [0, 2^31) and then wrap
TAG_SPACE = 1 << 31


class NodeMesh:
    """A mesh of the processes of the default group.  ``shape`` maps each
    axis name to its size, in order (as ``jax.sharding.Mesh.shape``);
    rank r sits at ``coords(r)``, the row-major index of r over the
    shape."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if not dist.is_initialized():
            raise ConfigError(
                "a NodeMesh needs a started process group: call "
                "init_node_group in each rank, or run through spawn_nodes")
        shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(shape) != len(self.axis_names) or len(
                set(self.axis_names)) != len(self.axis_names):
            raise ConfigError(f"mesh shape {shape} and axes "
                              f"{self.axis_names} do not match")
        self.shape = dict(zip(self.axis_names, shape))
        self.size = math.prod(shape)
        world = dist.get_world_size()
        if world != self.size:
            raise ConfigError(
                f"a mesh of shape {shape} needs {self.size} ranks, the "
                f"process group has {world}")
        self.group = dist.group.WORLD
        self.backend = dist.get_backend(self.group)
        self.rank = dist.get_rank()
        self.groups: dict = {}       # subgroups built on this mesh
        self._next_tag = 0

    def reserve_tags(self, count: int) -> int:
        """The first of ``count`` wire tags no earlier transport on this
        mesh was given.  Every rank reserves the same counts in the same
        order (one reservation a transport, sized from the plan before
        any wire is posted), so the ranks agree on every tag, and a wire
        that a failed run posted and nobody received can never match a
        later run's receive."""
        base = self._next_tag
        self._next_tag = (base + count) % TAG_SPACE
        return base

    def coords(self, rank: Optional[int] = None) -> tuple[int, ...]:
        """Coordinates of ``rank`` (default: this rank), one per axis."""
        r = self.rank if rank is None else rank
        out = []
        for size in reversed(list(self.shape.values())):
            r, c = divmod(r, size)
            out.append(c)
        return tuple(reversed(out))

    def coord(self, axis: str, rank: Optional[int] = None) -> int:
        """This rank's (or ``rank``'s) coordinate on ``axis``."""
        return self.coords(rank)[self.axis_names.index(axis)]


def flat_node_id(mesh, dp_axes: Sequence[str],
                 rank: Optional[int] = None) -> int:
    """Row-major flat protocol node id over the dp mesh axes, read from
    the mesh's coordinates of ``rank`` (default: this rank) -- not
    assumed to be the global rank."""
    nid = 0
    for ax in dp_axes:
        nid = nid * mesh.shape[ax] + mesh.coord(ax, rank)
    return nid


def slice_of(mesh, dp_axes: Sequence[str], rank: int) -> tuple:
    """``rank``'s coordinates on the mesh axes outside ``dp_axes``."""
    return tuple(mesh.coord(ax, rank) for ax in mesh.axis_names
                 if ax not in dp_axes)


def ranks_by_node(mesh, dp_axes: Sequence[str], sl: tuple) -> dict:
    """node id -> global rank, over the ranks of slice ``sl``."""
    return {flat_node_id(mesh, dp_axes, r): r for r in range(mesh.size)
            if slice_of(mesh, dp_axes, r) == sl}


def subgroup(mesh, dp_axes: Sequence[str], node_groups) -> tuple:
    """(group, sorted member ranks) of this rank among ``node_groups``
    (node ids), one group per node group in every slice of the other
    axes.  ``dist.new_group`` is collective over the default group, so
    every rank creates every group, in the same order, even those it is
    not in; they are built once per (mesh, dp axes, node groups) and
    cached on the mesh."""
    key = (tuple(dp_axes), tuple(tuple(g) for g in node_groups))
    if key not in mesh.groups:
        mine = None
        for sl in sorted({slice_of(mesh, dp_axes, r)
                          for r in range(mesh.size)}):
            by_node = ranks_by_node(mesh, dp_axes, sl)
            for nodes in key[1]:
                members = sorted(by_node[i] for i in nodes)
                group = dist.new_group(members)
                if mesh.rank in members:
                    mine = (group, members)
        mesh.groups[key] = mine
    return mesh.groups[key]


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> NodeMesh:
    """A mesh of the given shape over the default group."""
    return NodeMesh(shape, axes)


def host_mesh(data: int = 1, model: int = 1, pod: int = 0) -> NodeMesh:
    """The ("pod", "data", "model") or ("data", "model") mesh."""
    if pod:
        return NodeMesh((pod, data, model), ("pod", "data", "model"))
    return NodeMesh((data, model), ("data", "model"))


def node_mesh(n_nodes: int, axis: str = "data") -> NodeMesh:
    """One-rank-per-protocol-node mesh: the bootstrap of the
    ``MeshTransport`` callers.  The group must have exactly ``n_nodes``
    ranks."""
    return NodeMesh((n_nodes,), (axis,))


def axis_size(mesh: NodeMesh, axis_name: str) -> int:
    return mesh.shape[axis_name]


def init_node_group(rank: int, world: int, store_path: str,
                    backend: str = "gloo",
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Start this rank's default process group from a ``FileStore`` at
    ``store_path`` (a file no earlier group used).  A rank that does not
    join within ``timeout_s``, or a collective that waits longer, raises."""
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


def init_fake_group(rank: int, world: int) -> None:
    """Start this process's default group as rank ``rank`` of a fake
    group of ``world`` ranks (``torch.testing``'s ``fake`` backend): its
    collectives return at once and move nothing, so one process can trace
    one rank of a mesh of any size on meta tensors (the dry run)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _node_main(rank: int, fn, n: int, store_path: str, timeout_s: float,
               args: tuple) -> None:
    # the ranks share the host's cores: one rank's torch should not start
    # a thread per core
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    # every rank of spawn_nodes runs on this host: gloo's pairs connect
    # over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    init_node_group(rank, n, store_path, "gloo", timeout_s)
    try:
        fn(rank, *args)
    except BaseException:
        # the parent raises the error of the first rank it sees end,
        # which may be one that another rank's failure took down: each
        # rank's own error goes to stderr first
        print(f"rank {rank} of {n} failed:", file=sys.stderr)
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        dist.destroy_process_group()


def spawn_nodes(fn, n: int, *args,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Run ``fn(rank, *args)`` in ``n`` fresh processes (the ``spawn``
    start method: CUDA does not survive a fork), each inside a started
    gloo group of world size ``n`` (the ranks may share one card, which
    NCCL refuses).  ``fn`` must be importable by name.  Any
    rank that raises or dies ends the others and raises here."""
    tmp = tempfile.mkdtemp(prefix="repro-nodes-")
    try:
        torch.multiprocessing.start_processes(
            _node_main, args=(fn, n, os.path.join(tmp, "store"),
                              timeout_s, args),
            nprocs=n, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
