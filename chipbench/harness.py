"""The benchmark's frame: find a cell by name, check the card, run the
cell's driver, read the per-layer metrics from the traced window, judge
the outputs against their limits, and print the result line.

Everything a cell owns is found by name: ``BENCHMARK.json`` (at the root
of the checkout) lists the cells and metrics, ``workloads/<cell>.json``
holds the cell's driver, traffic parameters and correctness limits,
``configs/<config>.json`` its deployment, ``drivers/<driver>.py`` the
code that runs that kind of traffic, and ``metrics/<metric>.py`` the
reader of one per-layer metric.  Adding a cell, a configuration or a
metric adds files and entries; nothing here changes.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import importlib.util
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no process of the benchmark may hold: the
# JAX stack and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
# the benchmark's own spans, one around each timed call or step
BENCH_SPANS = ("bench.call", "bench.step")


class NoCard(RuntimeError):
    """A device metric asked of a run that was not on the card."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark found by file name (metric names hold
    dots, so they are not import paths)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One run of one cell: what the driver is handed."""
    name: str
    entry: dict            # the cell's entry in BENCHMARK.json
    config: dict           # configs/<config>.json
    workload: dict         # workloads/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = 0.0   # perf_counter at process start
    impl: Optional[str] = None   # the port's kernel engine (None: its own)

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


def find_cell(bench: dict, name: str, root: Path = HERE) -> tuple:
    """(BENCHMARK.json entry, config, workload file) of cell ``name``."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    config = load_json(root / "configs" / f"{entry['config']}.json")
    workload = load_json(root / "workloads" / f"{name}.json")
    return entry, config, workload


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end
    metrics, or with ``trace`` the per-layer ones that list the cell.
    Every per-layer entry lists its cells."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    unlisted = [m["name"] for m in bench["per_layer"] if "workloads" not in m]
    if unlisted:
        raise KeyError(f"per-layer metrics {unlisted} list no workloads")
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


# ---------------------------------------------------------------------------
# The measured window and its trace
# ---------------------------------------------------------------------------


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespaces,
    template arguments and parameters."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:          # drop every (...) and <...> group
        if ch in "(<":
            depth += 1
        elif ch in ")>":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    base = "".join(out).strip()
    return base.split("::")[-1].strip() or name[:64]


@dataclasses.dataclass
class Trace:
    """The device activity and host spans of a traced window, in seconds
    on the profiler's clock.  ``ops`` are (short name, kind, start, dur)
    with kind ``kernel``, ``memcpy`` or ``memset``; ``spans`` are
    (name, start, end) of ``record_function`` ranges."""
    ops: list
    spans: list
    window_s: float          # host clock, first timed call to last done
    iters: int               # calls or steps completed in the window
    cell: Optional[Cell] = None

    def bench_spans(self) -> list:
        return [s for s in self.spans if s[0] in BENCH_SPANS]

    def bounds(self) -> tuple:
        """(start, end) of the window on the trace's clock: the first
        timed call's start to the last device operation's or span's
        end."""
        own = self.bench_spans()
        if not own:
            raise ValueError("the trace holds none of the benchmark's "
                             f"spans {BENCH_SPANS}")
        lo = min(s[1] for s in own)
        return lo, max([s[2] for s in own] + [o[2] + o[3] for o in self.ops])

    def busy_intervals(self) -> list:
        """The union of device operations' intervals inside the window."""
        lo, hi = self.bounds()
        merged = []
        for _, _, s, d in sorted(self.ops, key=lambda o: o[2]):
            s, e = max(s, lo), min(s + d, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def trace_window_s(self) -> float:
        lo, hi = self.bounds()
        return hi - lo

    def op_time(self, match: Callable[[str], bool],
                kinds=("kernel",)) -> tuple[float, int]:
        """(seconds, count) of the operations whose short name matches."""
        sel = [o for o in self.ops if o[1] in kinds and match(o[0])]
        return sum(o[3] for o in sel), len(sel)

    def span_durations(self, name: str) -> list:
        return [e - s for n, s, e in self.spans if n == name]

    def device_ops(self, top: int = 10) -> list:
        tot: dict = {}
        for name, _, _, d in self.ops:
            tot[name] = tot.get(name, 0.0) + d
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time summed by the innermost host span open when
        each gap began (``(no span)`` between them)."""
        lo, hi = self.bounds()
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        busy = self.busy_intervals()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        tot: dict = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            name = "(no span)"
            for j in range(bisect.bisect_right(starts, a) - 1, -1, -1):
                if spans[j][2] > a:
                    name = spans[j][0]
                    break
            tot[name] = tot.get(name, 0.0) + (b - a)
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]


def _op_kind(ev, name: str) -> Optional[str]:
    """kernel / memcpy / memset for a device activity, None for the
    device-side copies of host annotations."""
    act = ""
    if hasattr(ev, "activity_type"):
        act = str(ev.activity_type()).lower()
    if "annotation" in act or ev.is_user_annotation():
        return None
    if "memcpy" in act or name.startswith("Memcpy"):
        return "memcpy"
    if "memset" in act or name.startswith("Memset"):
        return "memset"
    if act and "kernel" not in act and "gpu" not in act \
            and "concurrent" not in act:
        return None
    return "kernel"


def trace_from_events(events, window_s: float, iters: int,
                      cell: Optional[Cell] = None) -> Trace:
    ops, spans = [], []
    for ev in events:
        name = ev.name()
        start = ev.start_ns() * 1e-9
        dur = ev.duration_ns() * 1e-9
        if str(ev.device_type()).endswith("CUDA"):
            kind = _op_kind(ev, name)
            if kind is not None:
                ops.append((short_name(name), kind, start, dur))
        elif ev.is_user_annotation():
            spans.append((name, start, start + dur))
    return Trace(ops=ops, spans=spans, window_s=window_s, iters=iters,
                 cell=cell)


class Profile:
    """The traced window's profiler: the device's activity, and on the
    host only ``record_function`` ranges (the user scope).  The host's
    per-operator events are left out, since recording them slows a
    host-bound step by about half, and every host-clock and span metric
    would read that slower pace."""

    def __init__(self, cuda: bool):
        from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, _prepare_profiler)
        from torch._C._profiler import _ExperimentalConfig
        self.acts = {ProfilerActivity.CPU}
        if cuda:
            self.acts.add(ProfilerActivity.CUDA)
        self.config = ProfilerConfig(ProfilerState.KINETO, False, False,
                                     False, False, False,
                                     _ExperimentalConfig())
        _prepare_profiler(self.config, self.acts)

    def start(self) -> None:
        from torch.autograd import _enable_profiler
        from torch._C._profiler import RecordScope
        _enable_profiler(self.config, self.acts, {RecordScope.USER_SCOPE})

    def stop(self) -> list:
        from torch.autograd import _disable_profiler
        return list(_disable_profiler().events())


class Window:
    """The measured window: ``start()``, then ``tick()`` after each call
    or step has completed on the device (False once ``seconds`` have
    passed), then ``stop()``.  With ``trace`` the window runs under
    :class:`Profile` and ``stop()`` leaves its ``Trace``."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.prof: Optional[Profile] = None
        self.trace: Optional[Trace] = None
        self.iters = 0
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        if self.cell.trace:
            self.prof = Profile(self.cell.device.startswith("cuda"))
            self.prof.start()
        self.t0 = self.t1 = time.perf_counter()

    def tick(self) -> bool:
        self.iters += 1
        self.t1 = time.perf_counter()
        return self.t1 - self.t0 < self.cell.seconds

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def stop(self) -> None:
        if self.prof is not None:
            self.trace = trace_from_events(self.prof.stop(), self.seconds,
                                           self.iters, self.cell)
            self.prof = None


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: end-to-end values by name, each number
    compared as (name, value, limit), the peak, and the window."""
    attempted: int
    failed: int
    e2e: dict
    checks: list
    memory_peak_bytes: int
    window: Window
    details: Optional[dict] = None     # the readings behind the checks

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)


def percentile(values: list, q: int) -> float:
    """The q-th percentile of all values (linear between order
    statistics, ``statistics.quantiles``' inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: this
    process's), compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN_MODULES))


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it: the shares of a
    peak assume the full 700 W."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip().splitlines()[0] if p.stdout.strip() else None


def device_info(cell: Cell, peak: int) -> dict:
    import torch
    if cell.device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": int(cell.entry.get("chips", 1)),
                "memory_peak_bytes": int(peak),
                "power_limit": power_limit()}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def read_per_layer(bench: dict, cell: Cell, trace: Trace,
                   root: Path = HERE) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics_for(bench, cell.name, trace=True):
        reader = load_module(root / "metrics" / f"{m['name']}.py",
                             f"chipbench_metric_{len(out)}")
        value = reader.read(trace)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(bench: dict, cell: Cell, root: Path = HERE) -> dict:
    """Run the cell's driver and build its result (the printed line)."""
    driver = load_module(root / "drivers" / f"{cell.workload['driver']}.py",
                         "chipbench_driver")
    out: Outcome = driver.run(cell)
    win = out.window
    if cell.trace:
        metrics = read_per_layer(bench, cell, win.trace, root)
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in metrics_for(bench, cell.name, trace=False)}
    device = device_info(cell, out.memory_peak_bytes)
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    if cell.trace:
        tr = win.trace
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.trace_window_s()
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in out.checks}
    return result


def parse(argv: list) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list, t_start: float) -> int:
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    entry, config, workload = find_cell(bench, args.workload)
    import torch
    chips = int(entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"chipbench: cell {args.workload} needs {chips} CUDA "
              "device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    cell = Cell(name=args.workload, entry=entry, config=config,
                workload=workload, seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), device="cuda", t_start=t_start)
    result = run_cell(bench, cell)
    found = loaded_forbidden()
    if found:
        print(f"chipbench: the process holds {found}: the benchmark may "
              "load neither jax nor the JAX package", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def on_card(trace: Trace) -> Trace:
    """The trace, for a reader of device activity: a run off the card
    has none, and a device metric is never read from it."""
    if trace.cell is None or not trace.cell.device.startswith("cuda"):
        raise NoCard("a device metric is read only from a run on the card")
    return trace
