"""Batched serving across three architecture families -- dense GQA,
SSM, and the hybrid of Mamba2, attention and MoE -- through the port's
``serve``: a prefill of a batch of prompts, then greedy decode with the
KV / SSM caches.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu

Counterpart of the reference's ``examples/serve_lm.py``: qwen3-1.7b,
mamba2-370m and jamba-v0.1-52b at their smoke configs in float32, batch
4, prompts of 32 tokens, 16 tokens generated.  Everything runs on the
card unless ``--device cpu`` asks for the CPU.  The reference serves on
its one-device host mesh; the port's ``mesh=None`` is that, so none is
passed.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.serve import serve

ARCHS = ("qwen3-1.7b", "mamba2-370m", "jamba-v0.1-52b")
BATCH, PROMPT_LEN, GEN = 4, 32, 16


def main(device=None, params: Optional[dict] = None) -> dict:
    """Serve each arch in turn; returns ``serve``'s dict by arch.
    ``params`` (arch -> float32 weights of its float32 smoke config)
    replaces the seeded draw of the archs it names."""
    dev = resolve_device(device)
    params = params or {}
    outs = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        out = serve(cfg, batch=BATCH, prompt_len=PROMPT_LEN, gen=GEN,
                    device=dev, params=params.get(arch))
        print(f"{arch:18s} prefill {out['t_prefill_s'] * 1e3:7.1f}ms  "
              f"decode {out['t_decode_s'] * 1e3:7.1f}ms  "
              f"{out['tok_per_s']:6.1f} tok/s  "
              f"tokens[0,:8]={out['tokens'][0, :8].tolist()}")
        outs[arch] = out
    return outs


def cli(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the card")
    args = ap.parse_args(argv)
    return main(device=args.device)


if __name__ == "__main__":
    cli()
