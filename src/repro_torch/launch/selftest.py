"""Multi-process self-test of the distributed secure aggregation path.

    python -m repro_torch.launch.selftest --ranks 16 --device cpu|cuda

Counterpart of ``repro/launch/selftest.py``.  Spawns N rank processes
over gloo, one protocol node each (on ``cuda`` every rank runs the
kernels on card 0 and stages its wires through host memory), and checks
for every schedule x transport x masking, on a 1-D ("data",) mesh and a
2-D ("pod", "data") mesh:

  * the ``mesh`` backend's result == the port's single-device sim
    oracle, bit for bit -- including the digest transport;
  * the result == the plain sum (rounded once to float32) within 4x the
    quantization bound;
  * a Byzantine flip of one member per cluster (a vote minority) is
    fully corrected.

Prints ``selftest OK`` and exits 0; a failure in any rank exits non-zero.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.api import AggConfig, Runtime, SecureAggregator
from repro_torch.core.byzantine import ByzantineSpec
from repro_torch.core.masking import quantization_error_bound
from repro_torch.runtime import compat

SCHEDULES = ("ring", "tree", "butterfly")
TRANSPORTS = ("full", "digest")
MASKINGS = ("global", "pairwise", "none")


def check(rank: int, name: str, ok: bool, detail: str = "") -> None:
    if rank == 0 or not ok:
        print(f"[{'PASS' if ok else 'FAIL'}] {name} {detail}", flush=True)
    if not ok:
        raise RuntimeError(f"rank {rank}: {name} failed {detail}")


def _cells(n: int):
    for schedule in SCHEDULES:
        for transport in TRANSPORTS:
            for masking in MASKINGS:
                yield (f"{schedule}/{transport}/{masking}",
                       AggConfig(n_nodes=n, cluster_size=4, redundancy=3,
                                 schedule=schedule, transport=transport,
                                 masking=masking, clip=2.0))
    corrupt = tuple(range(0, n, 4))   # member 0 of each cluster of 4
    for schedule in SCHEDULES:
        for transport in TRANSPORTS:
            yield (f"byzantine {schedule}/{transport}",
                   AggConfig(n_nodes=n, cluster_size=4, redundancy=3,
                             schedule=schedule, transport=transport,
                             masking="global", clip=2.0,
                             byzantine=ByzantineSpec(corrupt_ranks=corrupt,
                                                     mode="flip")))


def node(rank: int, n: int, device: str) -> None:
    if device == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.normal(size=(n, 1024)).astype(np.float32)
                          * 0.3).to(dev)
    # the plain sum, rounded once to float32 (torch's float32 reduction
    # adds in another order than XLA's)
    true_sum = xs.double().sum(0).float()
    meshes = [compat.make_mesh((n,), ("data",))]
    if n % 2 == 0:
        meshes.append(compat.make_mesh((2, n // 2), ("pod", "data")))
    for mesh in meshes:
        axes = mesh.axis_names
        for name, cfg in _cells(n):
            agg = SecureAggregator(cfg, runtime=Runtime(
                backend="mesh", mesh=mesh, dp_axes=axes), device=dev)
            got = agg.allreduce(xs)
            bound = quantization_error_bound(cfg.mask_cfg()) * 4
            err = float((got - true_sum[None]).abs().max())
            check(rank, f"{axes} {name}", err < bound,
                  f"err={err:.2e} bound={bound:.2e}")
            sim = SecureAggregator(cfg, runtime=Runtime(backend="sim"),
                                   device=dev).allreduce(xs)
            check(rank, f"  sim-match {name}", torch.equal(sim, got),
                  f"max|sim-dist|={float((sim - got).abs().max()):.2e}")
            check(rank, f"  bytes {name}",
                  agg.stats()["bytes_sent"] == agg.cost(xs.shape[1])[
                      "bytes_total"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=16)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu")
        from repro_torch.kernels import build
        build.lib()           # build once here; the ranks load the library
    compat.spawn_nodes(node, args.ranks, args.ranks, args.device)
    print("selftest OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
