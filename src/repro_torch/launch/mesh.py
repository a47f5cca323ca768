"""Host meshes of the training and serving entry points.

Counterpart of ``repro/launch/mesh.py`` over the port's ``NodeMesh`` (one
process a node of a ``torch.distributed`` group).  ``make_production_mesh``
gives the reference's production meshes (16 x 16, or 2 x 16 x 16 with
its pods) over a started group of that world size: in the dry run a fake
group (``compat.init_fake_group``), of which one process is one rank.
Nothing here touches a process group at import time.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

import torch.distributed as dist

from repro_torch.runtime import compat


def make_production_mesh(*, multi_pod: bool = False) -> compat.NodeMesh:
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the
    (2, 16, 16) ("pod", "data", "model") one, over the started group
    (which must have 256 or 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat.make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0
                   ) -> compat.NodeMesh:
    """The ("pod", "data", "model") or ("data", "model") mesh over the
    ranks of the started process group (``compat.host_mesh``)."""
    return compat.host_mesh(data=data, model=model, pod=pod)


def dp_axes_of(mesh: compat.NodeMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: compat.NodeMesh) -> int:
    n = 1
    for a in dp_axes_of(mesh):
        n *= mesh.shape[a]
    return n


@contextlib.contextmanager
def single_rank_mesh():
    """A one-rank ("data", "model") mesh: the counterpart of the
    reference's one-device host mesh.  In a process with no process group
    it starts a gloo group of world size 1 (a ``FileStore`` in a temporary
    directory) and destroys it on exit; a process that already has a
    one-rank group gets a mesh over it.  A one-rank secure sync makes no
    collective call: its plan has no hops and its cluster sum is the
    identity."""
    if dist.is_initialized():
        yield make_host_mesh()
        return
    tmp = tempfile.mkdtemp(prefix="repro-mesh-")
    compat.init_node_group(0, 1, os.path.join(tmp, "store"))
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
