"""Byzantine-robust training: gradient-corrupting ranks inside the secure
aggregation ring, and the majority vote keeping training on the baseline
trajectory (the paper's correctness property at tensor scale).

Counterpart of ``examples/byzantine_training.py``, placed in the package
(as ``launch.secure_polling`` is):

    PYTHONPATH=src python -m repro_torch.launch.byzantine_training \\
        [--ranks 8] [--steps 12] [--device cpu] [--json OUT]

``--ranks`` gloo ranks (``runtime.compat.spawn_nodes``, every rank on the
same device) train the olmo-1b smoke config in float32 three times in one
spawn: the baseline (a plain all-reduce of the gradients), the secure
sync with clusters of 4, r = 3 and one corrupt member in every cluster
(ranks 1, 5, ...; ``mode="garbage"``), which the vote must absorb (losses
within 5e-3 of the baseline), and the same corruption at r = 1, which it
cannot (the control).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.byzantine import ByzantineSpec
from repro_torch.core.plan import AggConfig
from repro_torch.launch.train import run_ranks
from repro_torch.optim import adamw

TOL = 5e-3
CLUSTER_SIZE = 4


def run(ranks: int = 8, steps: int = 12, device="cuda") -> dict:
    """The three runs' losses, rank 0's kernel launches in each, and the
    largest loss deviations from the baseline."""
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32")
    shape = ShapeConfig("byz", seq_len=64, global_batch=ranks,
                        kind="train")
    opt = adamw.OptConfig(lr=2e-3, warmup_steps=5, total_steps=100)
    # one corrupt member per cluster (< r/2 of r = 3 votes)
    corrupt = tuple(range(1, ranks, CLUSTER_SIZE))
    agg = AggConfig(n_nodes=ranks, cluster_size=CLUSTER_SIZE, redundancy=3,
                    clip=8.0, byzantine=ByzantineSpec(corrupt_ranks=corrupt,
                                                      mode="garbage"))
    runs = [{}, {"secure": True, "agg": agg},
            {"secure": True, "agg": agg.replace(redundancy=1)}]
    base, sec, bad = run_ranks(ranks, runs, cfg=cfg, steps=steps,
                               shape=shape, opt_cfg=opt, log_every=4,
                               device=device)

    def dev(r):
        return float(np.max(np.abs(np.asarray(base["losses"])
                                   - np.asarray(r["losses"]))))

    return {"ranks": ranks, "cluster_size": CLUSTER_SIZE, "redundancy": 3,
            "corrupt": list(corrupt), "steps": steps,
            "baseline": base, "secure": sec, "control_r1": bad,
            "max_dev_secure": dev(sec), "max_dev_control_r1": dev(bad),
            "tol": TOL}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", help="write the result here")
    args = ap.parse_args()
    out = run(args.ranks, args.steps, args.device)
    print(f"max |loss_base - loss_byzantine_secure| = "
          f"{out['max_dev_secure']:.2e}")
    print(f"without voting (r=1): max deviation = "
          f"{out['max_dev_control_r1']:.2e}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)
    if out["max_dev_secure"] >= TOL:
        raise SystemExit("the vote failed to correct the byzantine "
                         "gradients")
    print("majority vote fully corrected the corrupted ring traffic")


if __name__ == "__main__":
    main()
