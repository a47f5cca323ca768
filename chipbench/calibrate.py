"""Readings behind a cell's correctness limits, on the card at the cell's
own size: the program's numbers over many seeds, and over a few seeds
the control's (the reference in a lower precision put in the program's
place) and the faults'.  The benchmark's own runs never run this.

    python3 chipbench/calibrate.py --workload qwen3-1.7b.train-secure \\
        --seeds 11,12,13 --control-seeds 11,12,13

Prints one JSON line a reading.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from chipbench import compare, harness  # noqa: E402


def _cell(bench, name: str, seed: int, device: str) -> harness.Cell:
    entry, config, workload = harness.find_cell(bench, name)
    return harness.Cell(name=name, entry=entry, config=config,
                        workload=workload, seed=seed, seconds=0.0,
                        trace=False, device=device,
                        t_start=time.perf_counter())


def allreduce_readings(cell: harness.Cell, control: bool) -> dict:
    import torch
    from chipbench.reference import secagg
    from chipbench.traffic import payloads
    driver = harness.load_module(harness.HERE / "drivers" / "allreduce.py",
                                 "chipbench_driver")
    out = {"program": driver.run(cell).details}
    if control:
        p = cell.config["protocol"]
        xs = payloads.node_payloads(cell.seed, p["n_nodes"],
                                    cell.config["payload"]["elems_per_node"],
                                    cell.traffic, torch.device(cell.device))[0]
        want = secagg.exact_sum(xs, p["clip"], p["guard_bits"])
        got = secagg.float_sum(xs, p["clip"], p["guard_bits"])
        out["control"] = {"mismatched_elements":
                          int((got != want).sum()) * p["n_nodes"]}
    return out


def train_readings(cell: harness.Cell, control: bool) -> dict:
    import torch
    from chipbench.reference import qwen3
    from chipbench.traffic import tokens
    driver = harness.load_module(harness.HERE / "drivers" / "train.py",
                                 "chipbench_driver")
    d = driver.run(cell).details
    out = {"program": d["gaps"]}
    if control:
        t, c = cell.traffic, cell.config
        dev = torch.device(cell.device)
        batches = tokens.batches(cell.seed, driver.SETUP_STEPS, t["batch"],
                                 t["seq_len"], c["vocab_size"], dev)
        secure = t["sync"] == "secure"
        low = qwen3.train_readings(c, cell.seed, batches, dev, secure=secure,
                                   steps=driver.SETUP_STEPS, low=True)
        out["control"] = compare.gaps(low, d["reference"])
        half = qwen3.train_readings(c, cell.seed, batches, dev,
                                    secure=secure, steps=driver.SETUP_STEPS,
                                    rows=slice(0, t["batch"] // 2))
        out["half_batch"] = compare.gaps(half, d["reference"])
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    kind = harness.find_cell(bench, args.workload)[2]["driver"]
    read = {"allreduce": allreduce_readings, "train": train_readings}[kind]
    for seed in seeds + sorted(ctrl - set(seeds)):
        t0 = time.perf_counter()
        r = read(_cell(bench, args.workload, seed, args.device),
                 control=seed in ctrl)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
