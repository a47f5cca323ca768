"""A/B timing of the port's SSD scan and its backward, Montgomery
multiply and flash attention backward across source trees, on one GPU,
in turns.

    python3 kernel_ab.py --tree parent=<checkout> --tree change=. \
        --order parent,change,change,parent [--out build/ab.json] \
        [--kernels ssd,mont_mul,flash_bwd,ssd_bwd]

Each turn starts one Python process whose import path holds that tree's
``src/`` first; the process builds that tree's kernels (into the tree's
own ``build/``) and times them with this checkout's ``chip_smoke.py``
timing functions, so every tree gets one method and one input set:
``time_ssd`` (``ssd_chunked`` at mamba2-370m's prefill),
``time_mont_mul`` (``mont_mul_op`` at a threshold decryption's 58 rows x
128 limbs) and ``time_flash_bwd`` (the flash backward at qwen3-1.7b's
training shape, beside ``scaled_dot_product_attention``'s backward)
and ``time_ssd_bwd`` (the SSD backward at mamba2-370m's training
shape); ``--kernels`` picks among them (a tree older than a backward
leaves it out).  The inputs come from one seed and are the same
in every turn.  Prints one JSON line a turn, then the card's name and power limit
as ``nvidia-smi`` gives them, and exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

CHILD = r'''
import json, pathlib, sys, time
import numpy as np
import torch
here, src, kernels = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
sys.path.insert(0, here)
import chip_smoke                      # puts this checkout's src/ first
sys.path.insert(0, src)
import repro_torch
from repro_torch.kernels import build
assert pathlib.Path(repro_torch.__file__).is_relative_to(src), \
    repro_torch.__file__
dev = torch.device("cuda", 0)
t0 = time.perf_counter()
build.lib()
build_s = time.perf_counter() - t0
out = {"build_s": build_s}
if "ssd" in kernels:
    out["ssd"] = chip_smoke.time_ssd(np.random.default_rng(0), dev)
if "mont_mul" in kernels:
    out["mont_mul"] = chip_smoke.time_mont_mul(
        np.random.default_rng(0), dev, [(58, 128)])["58x128"]
if "flash_bwd" in kernels:
    out["flash_bwd"] = chip_smoke.time_flash_bwd(np.random.default_rng(0),
                                                 dev)
if "ssd_bwd" in kernels:
    out["ssd_bwd"] = chip_smoke.time_ssd_bwd(np.random.default_rng(0), dev)
print(json.dumps(out))
'''


def smi_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="name=path of a checkout (repeatable)")
    ap.add_argument("--order", required=True,
                    help="comma-separated tree names, one turn each")
    ap.add_argument("--out", default=None, help="also write the turns here")
    ap.add_argument("--kernels", default="ssd,mont_mul,flash_bwd",
                    help="comma-separated subset of "
                    "ssd,mont_mul,flash_bwd,ssd_bwd")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this timing needs a GPU", file=sys.stderr)
        return 1
    trees = dict(t.split("=", 1) for t in args.tree)
    here = pathlib.Path(__file__).resolve().parent
    turns = []
    for name in args.order.split(","):
        root = pathlib.Path(trees[name]).resolve()
        proc = subprocess.run([sys.executable, "-c", CHILD, str(here),
                               str(root / "src"), args.kernels], cwd=root,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        turn = {"tree": name, **json.loads(proc.stdout.strip()
                                            .splitlines()[-1])}
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    smi = smi_line()
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(
            {"turns": turns, "nvidia_smi": smi}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
