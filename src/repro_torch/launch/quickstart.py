"""Quickstart: the ``repro_torch`` front door in three verbs (allreduce /
cost / stats), then train a tiny LM with the paper's secure aggregation
as the gradient sync and decode from it.

    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

Counterpart of the reference's ``examples/quickstart.py``: the same
facade demo, ``train_loop(..., secure=True)`` on olmo-1b's smoke config
for 60 steps on a one-rank mesh (the loss must fall), then ``serve`` on
the same config.  Everything runs on the card unless ``--device cpu``
asks for the CPU.  The reference serves on its one-device host mesh;
the port's ``mesh=None`` is that, so none is passed.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.api import SecureAggregator, Topology
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train_loop
from repro_torch.optim import adamw

SHAPE = ShapeConfig("quickstart", seq_len=128, global_batch=8, kind="train")
OPT = adamw.OptConfig(lr=3e-3, warmup_steps=10, total_steps=200)


def facade_demo(device=None) -> dict:
    """One front door: aggregate 16 nodes' vectors, ask what it costs."""
    agg = SecureAggregator(topology=Topology(n_nodes=16, cluster_size=4),
                           device=device)
    xs = np.random.default_rng(0).normal(size=(16, 512)).astype(np.float32)
    xs *= 0.05
    out = agg.allreduce(xs)                   # (16, 512) per-node results
    err = float(np.abs(out[0].cpu().numpy() - xs.sum(0)).max())
    k = agg.cost(512)
    caches = agg.stats()["fn_cache"]
    print(f"secure allreduce of (16, 512): max|err|={err:.1e}, "
          f"{k['rounds']} voted rounds, "
          f"{k['bytes_per_node'] / 1e3:.1f} kB/node "
          f"(caches: {caches})")
    return {"err": err, "rounds": k["rounds"],
            "bytes_per_node": k["bytes_per_node"], "fn_cache": caches}


def main(device=None, steps: int = 60, params=None) -> dict:
    """The three parts in order; returns the facade demo's numbers, the
    training run (``train_loop``'s dict) and the serve's.  ``params``
    (float32 master weights of olmo-1b's smoke config) replaces the
    training run's seeded init."""
    dev = resolve_device(device)
    print("== repro_torch.api facade ==")
    facade = facade_demo(dev)

    cfg = get_smoke_config("olmo-1b")
    print("== training with secure aggregation (paper mode) ==")
    out = train_loop(cfg, steps=steps, shape=SHAPE, secure=True,
                     opt_cfg=OPT, log_every=10, device=dev, params=params)
    print(f"loss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
    assert out["losses"][-1] < out["losses"][0]

    print("== serving ==")
    res = serve(cfg, batch=2, prompt_len=16, gen=8, device=dev)
    print("generated:", res["tokens"])
    print(f"decode throughput: {res['tok_per_s']:.1f} tok/s "
          f"({dev.type})")
    return {"facade": facade, "train": out, "serve": res}


def cli(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the card")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    return main(device=args.device, steps=args.steps)


if __name__ == "__main__":
    cli()
