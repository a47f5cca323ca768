"""Render the dry-run / roofline markdown tables from the port's records
(``reports/torch/dryrun/*.json``, and the hillclimb's from
``reports/torch/perf/*.json``).

    PYTHONPATH=src python -m repro_torch.roofline.report > reports/torch/roofline.md
    PYTHONPATH=src python -m repro_torch.roofline.report --base DIR
    PYTHONPATH=src python -m repro_torch.roofline.report --grid

Counterpart of ``repro/roofline/report.py``, with the same three tables;
``--grid`` folds the first into one row an arch and one column a shape.
Every figure is an estimate: the counted work of one rank's traced step
(``roofline.analysis``) over the H100's datasheet constants
(``roofline.hw``), never a time taken on the card.  A refused cell
(a ``ConfigError``) is listed with its reason.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.roofline import hw

BASE = os.path.join(os.path.dirname(__file__), "..", "..", "..", "reports",
                    "torch")


def load_dir(d):
    out = []
    if not os.path.isdir(d):
        return out
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                out.append(json.load(fh))
    return out


def fmt(x, n=4):
    if x is None:
        return "—"
    return f"{x:.{n}f}"


def onesent(rec) -> str:
    """One sentence on what would move the dominant term down."""
    dom = rec["terms"]["dominant"]
    arch, shape = rec["arch"], rec["shape"]
    moe = "moe" in arch or "maverick" in arch or "jamba" in arch
    if dom == "memory_s":
        if moe and shape.startswith("train"):
            return ("shrink the EP dispatch buffers (capacity factor, "
                    "seq-chunked dispatch) — they dominate HBM traffic")
        if shape.startswith("decode") or shape == "long_500k":
            return "KV-cache reads dominate; shard cache wider / quantize KV"
        return ("op-by-op traffic: fuse the norms, casts and the float32 "
                "logits' passes into the kernels")
    if dom == "collective_s":
        return ("overlap the a2a/all-reduce with expert/attention compute; "
                "reduce payload via digest-vote or compression")
    return "increase per-chip arithmetic intensity (larger per-device batch)"


def render(base: str = BASE) -> str:
    recs = load_dir(os.path.join(base, "dryrun"))
    gb = hw.HBM_BYTES / 1e9
    lines = [
        "## Roofline — per (arch × shape × mesh), from the traced dry run",
        "",
        "Estimates: one rank's counted work over the H100's datasheet "
        f"constants ({hw.PEAK_FLOPS_BF16:.3g} FLOP/s bf16, "
        f"{hw.HBM_BW:.3g} B/s HBM, {hw.NVLINK_BW:.3g} B/s NVLink); no "
        "time of the card.",
        "",
        "| arch | shape | mesh | compute_s | memory_s | collective_s |"
        f" dominant | MODEL_FLOPs/counted FLOPs | fits {gb:.0f} GB |"
        " bottleneck note |",
        "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if "refused" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                         f"| — | — | — | refused | — | — "
                         f"| {r['refused']} |")
            continue
        t = r["terms"]
        mem_gb = (r["memory"]["argument_bytes"]
                  + r["memory"]["temp_bytes"]) / 1e9
        fits = "✓" if r["memory"]["fits_hbm_est"] else f"✗ ({mem_gb:.0f} GB)"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {fmt(t['compute_s'])} | {fmt(t['memory_s'])} "
            f"| {fmt(t['collective_s'])} | {t['dominant'].replace('_s', '')} "
            f"| {fmt(r['useful_flops_ratio'], 2)} | {fits} "
            f"| {onesent(r)} |")
    lines += [
        "", "## Dry run — trace stats", "",
        "| arch | shape | mesh | trace_s | arg GB/dev | temp GB/dev |"
        " collective bytes/dev | counted flops/dev |",
        "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if "refused" in r:
            continue
        c = r["counted"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_lower_s']} "
            f"| {r['memory']['argument_bytes'] / 1e9:.2f} "
            f"| {r['memory']['temp_bytes'] / 1e9:.2f} "
            f"| {c['collective_bytes_total']:.3e} "
            f"| {c['flops']:.3e} |")
    perf = load_dir(os.path.join(base, "perf"))
    if perf:
        lines += [
            "", "## Hillclimb variants", "",
            "| tag | compute_s | memory_s | collective_s | dominant |"
            " collective bytes/dev | temp GB/dev |",
            "|---|---|---|---|---|---|---|"]
        for r in perf:
            if "refused" in r:
                lines.append(f"| {r['tag']} | — | — | — | refused | — "
                             f"| {r['refused']} |")
                continue
            t = r["terms"]
            lines.append(
                f"| {r['tag']} | {fmt(t['compute_s'])} "
                f"| {fmt(t['memory_s'])} | {fmt(t['collective_s'])} "
                f"| {t['dominant'].replace('_s', '')} "
                f"| {r['counted']['collective_bytes_total']:.3e} "
                f"| {r['temp_bytes'] / 1e9:.1f} |")
    return "\n".join(lines)


SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def grid(base: str = BASE) -> str:
    """The roofline table folded to one row an arch and one column a
    shape, one table a mesh: each cell the dominant term's estimated
    seconds, the other two, and the rank's arguments plus peak
    temporaries in GB against the card's (✗ where they do not fit)."""
    recs = load_dir(os.path.join(base, "dryrun"))
    cells: dict = {}
    for r in recs:
        cells[(r["mesh"], r["arch"], r["shape"])] = r
    lines = []
    for mesh in sorted({m for m, _, _ in cells}):
        archs = sorted({a for m, a, _ in cells if m == mesh})
        lines += [f"Mesh {mesh} (estimates: dominant term s (compute c, "
                  "memory m, collective x); arguments + peak GB a rank):",
                  "", "| arch | " + " | ".join(SHAPE_ORDER) + " |",
                  "|---" * (len(SHAPE_ORDER) + 1) + "|"]
        for a in archs:
            row = []
            for sh in SHAPE_ORDER:
                r = cells.get((mesh, a, sh))
                if r is None:
                    row.append("—")
                elif "refused" in r:
                    row.append("refused")
                else:
                    t = r["terms"]
                    gb = (r["memory"]["argument_bytes"]
                          + r["memory"]["temp_bytes"]) / 1e9
                    terms = {"c": t["compute_s"], "m": t["memory_s"],
                             "x": t["collective_s"]}
                    key = {"compute_s": "c", "memory_s": "m",
                           "collective_s": "x"}[t["dominant"]]
                    rest = ", ".join(f"{k} {v:.3g}" for k, v in
                                     terms.items() if k != key)
                    fits = "" if r["memory"]["fits_hbm_est"] else " ✗"
                    row.append(f"{key} {terms[key]:.3g} ({rest}); "
                               f"{gb:.3g}{fits}")
            lines.append(f"| {a} | " + " | ".join(row) + " |")
        lines.append("")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default=BASE,
                    help="the directory holding dryrun/ and perf/")
    ap.add_argument("--grid", action="store_true",
                    help="one row an arch, one column a shape")
    args = ap.parse_args()
    print(grid(args.base) if args.grid else render(args.base))


if __name__ == "__main__":
    main()
