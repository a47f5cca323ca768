"""Train an OLMo-style language model for a few hundred steps with
checkpoints and the secure aggregation as the gradient sync.

Counterpart of ``examples/train_lm.py``:

    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 300 \\
        [--small] [--device cpu] [--ckpt-dir DIR]

``model_100m`` is a ~100M-parameter OLMo-style model (non-parametric
LayerNorm, tied embeddings, float32); ``--small`` trains the 20M
variant.  One process: the secure sync runs on a one-rank mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.api import SecureAggregator
from repro_torch.configs.base import LayerSpec, ModelConfig, ShapeConfig
from repro_torch.core.plan import AggConfig
from repro_torch.launch.train import SYNC_CHUNK_ELEMS, train_loop
from repro_torch.optim import adamw


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="olmo-100m", family="dense",
        d_model=640, n_heads=10, n_kv_heads=10, head_dim=64,
        d_ff=2560, vocab_size=50304,
        pattern=(LayerSpec("attn", "dense"),), n_units=12,
        norm="nonparam_ln", tie_embeddings=True, dp_mode="replicated",
        dtype="float32", remat=False,
    )


def model_20m() -> ModelConfig:
    return dataclasses.replace(model_100m(), d_model=256, n_heads=4,
                               n_kv_heads=4, d_ff=1024, n_units=8,
                               vocab_size=8192, head_dim=64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = model_20m() if args.small else model_100m()
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")
    shape = ShapeConfig("lm", seq_len=256, global_batch=8, kind="train")
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                          grad_clip=1.0)
    # the gradient-sync committee, derived from one shared config
    # (reclamped to the one data-parallel rank here)
    agg = AggConfig(n_nodes=4, clip=8.0,
                    chunk_elems=SYNC_CHUNK_ELEMS).derive(n_nodes=1)
    k = SecureAggregator(agg, device=args.device).cost(agg.chunk_elems)
    print(f"secure sync: n={agg.n_nodes} c={agg.cluster_size} "
          f"r={agg.redundancy}, {k['rounds']} voted rounds, "
          f"{k['bytes_per_node'] / 1e6:.2f} MB/node/chunk")
    with tempfile.TemporaryDirectory(prefix="train-lm-") as tmp:
        out = train_loop(cfg, steps=args.steps, shape=shape,
                         secure=True, agg=agg, opt_cfg=opt,
                         ckpt_dir=args.ckpt_dir or os.path.join(tmp, "ck"),
                         ckpt_every=50, log_every=10, device=args.device)
    losses = out["losses"]
    l0 = sum(losses[:10]) / len(losses[:10])
    l1 = sum(losses[-10:]) / len(losses[-10:])
    print(f"mean loss first-10 {l0:.3f} -> last-10 {l1:.3f}")
    if not l1 < l0:
        raise SystemExit("no learning?")


if __name__ == "__main__":
    main()
