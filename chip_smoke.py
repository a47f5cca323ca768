"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--phases device,build,kernels,...]

Phases, in order; each prints one JSON line and any failure ends the run
with a non-zero exit code:

  device   the card's name, and its name and power limit from nvidia-smi
  build    build the CUDA kernels from ``src/repro_torch/csrc``
  kernels  each CUDA kernel against its plain torch version on the card,
           bit for bit, over lengths, modes, counter offsets near 2^32
           and vote copies with and without a majority
  main     the secure allreduce at full width -- n = 64 nodes, clusters
           of 4, ring schedule, r = 3, global masking, T = 2^22 float32
           per node -- through ``SecureAggregator.allreduce`` on the card:
           equal to the plain reference sum and to the plain-version run,
           executed wire bytes equal to ``cost``, kernel launch counts;
           then the digest transport and a flip adversary
  batched  ``allreduce_batched`` with S = 64 sessions of n = 16, T = 2^16
  timing   CUDA-event medians of each kernel and its plain version at
           the main path's shapes, and the end-to-end allreduce time

The last lines are the card's name and power limit, one JSON object
describing every kernel, and ``{"ok": true, "device": {...}}``.  Without
a CUDA device the script fails before printing any result.  Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

PHASES = ("device", "build", "kernels", "main", "batched", "timing")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
# 32-bit lane operations issued per second: 132 SMs x 128 lanes x
# 1.98 GHz, half the 67 TFLOP/s float32 FMA rate (an FMA counts two FLOPs)
LANE_OPS_PER_S = 67e12 / 2
# 32-bit integer add, logical, shift and multiply on sm_90: 64 results
# per clock per SM, half the lane rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9
N_MAIN, C_MAIN, T_MAIN = 64, 4, 1 << 22
SPLITMIX_OPS = 9              # add, 3 shifts, 3 xors, 2 multiplies
PAD_OPS = SPLITMIX_OPS + 2    # ctr ^ k1, then + k2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|: int32 words compare as uint32 values."""
    if a.numel() == 0:
        return 0.0
    if a.dtype == torch.int32:
        a, b = a.to(torch.int64) & 0xFFFFFFFF, b.to(torch.int64) & 0xFFFFFFFF
    return float((a.double() - b.double()).abs().max())


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def words(rng, shape, dev) -> torch.Tensor:
    a = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(dev)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs a GPU")
    return {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi_line(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def phase_build() -> dict:
    from repro_torch.kernels.secure_agg import build
    t0 = time.perf_counter()
    build.lib()
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "compiled": build.build_seconds is not None,
            "library": build.library_path().name,
            "ptxas": build.build_log.strip().splitlines()}


def phase_kernels(rng, dev, errs: dict) -> dict:
    """Every kernel against its plain version on the same card inputs."""
    from repro_torch.kernels.secure_agg import ops
    scale, clip = 2.0 ** 20, 1.0
    checks = 0
    for T in (1, 77, 8193, 1 << 22):
        B = 2
        x = torch.from_numpy((rng.standard_normal((B, T), np.float32)
                              * 0.7)).to(dev)
        edges = torch.tensor([0.5, 1.5, -0.5, -2.5], device=dev) / scale
        x[:, :min(T, 4)] = edges[:min(T, 4)]
        seeds = rng.integers(0, 2 ** 32, size=B, dtype=np.uint32)
        agg = words(rng, (B, T), dev)
        for off in (0, 2 ** 32 - 50):
            offs = np.full(B, off, np.uint32)
            for mode, c, nids in (("mask", 0, [3, 9]), ("quantize", 0, [0, 1]),
                                  ("pairwise", 2, [0, 5]),
                                  ("pairwise", 4, [6, 13])):
                got = ops.mask_encrypt_batch_fn(x, nids, seeds, scale, clip,
                                                mode=mode, offsets=offs,
                                                cluster_size=c)
                want = ops.mask_encrypt_batch_fn(x, nids, seeds, scale, clip,
                                                 mode=mode, offsets=offs,
                                                 cluster_size=c,
                                                 impl="torch")
                errs["mask_encrypt"] = max(errs["mask_encrypt"],
                                           max_abs_err(got, want))
                check(torch.equal(got, want),
                      f"mask_encrypt T={T} mode={mode} c={c} off={off}")
                checks += 1
            for mode, n in (("mask", 1), ("mask", 64), ("dequantize", 64)):
                got = ops.unmask_decrypt_batch_fn(agg, n, seeds, scale,
                                                  mode=mode, offsets=offs)
                want = ops.unmask_decrypt_batch_fn(agg, n, seeds, scale,
                                                   mode=mode, offsets=offs,
                                                   impl="torch")
                errs["unmask_decrypt"] = max(errs["unmask_decrypt"],
                                             max_abs_err(got, want))
                check(torch.equal(got, want),
                      f"unmask_decrypt T={T} mode={mode} n={n} off={off}")
                checks += 1
        for r in (1, 3, 5):
            for majority in (False, True):
                copies = [words(rng, (B, T), dev) for _ in range(r)]
                if majority:
                    copies[:r // 2 + 1] = [copies[0]] * (r // 2 + 1)
                acc = words(rng, (B, T), dev)
                got = ops.vote_combine_batch_fn(copies, acc)
                want = ops.vote_combine_batch_fn(copies, acc, impl="torch")
                errs["vote_combine"] = max(errs["vote_combine"],
                                           max_abs_err(got, want))
                check(torch.equal(got, want),
                      f"vote_combine T={T} r={r} majority={majority}")
                checks += 1
    torch.cuda.synchronize()
    return {"phase": "kernels", "checks": checks, "equal": True,
            "max_abs_err": errs}


def _main_cfg(**kw):
    from repro_torch import Security, Topology, Wire
    return dict(topology=Topology(n_nodes=N_MAIN, cluster_size=C_MAIN,
                                  schedule="ring"),
                security=Security(redundancy=3, masking="global",
                                  **kw.pop("security", {})),
                wire=Wire(**kw.pop("wire", {})), **kw)


def _run(agg, xs) -> tuple:
    """One allreduce: (result, executed bytes, host seconds)."""
    before = agg.stats()["bytes_sent"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = agg.allreduce(xs)
    torch.cuda.synchronize()
    return out, agg.stats()["bytes_sent"] - before, time.perf_counter() - t0


def phase_main(xs, ref, dev) -> tuple[dict, dict]:
    from repro_torch import Runtime, SecureAggregator
    from repro_torch.core.byzantine import ByzantineSpec
    from repro_torch.kernels.secure_agg import ops
    agg = SecureAggregator(**_main_cfg(), device=dev)
    want_bytes = agg.cost(T_MAIN)["bytes_total"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out, sent, secs = _run(agg, xs)
    launches = ops.launch_counts()
    check(launches["mask_encrypt"] >= 1 and launches["unmask_decrypt"] >= 1
          and launches["vote_combine"] >= 15, f"launches {launches}")
    check(tuple(out.shape) == (N_MAIN, T_MAIN), f"shape {out.shape}")
    check(bool(torch.isfinite(out).all()), "finite result")
    check(torch.equal(out, ref.expand_as(out)), "full: equals reference")
    check(sent == want_bytes, f"full: bytes {sent} != cost {want_bytes}")
    host_s = [secs]
    for _ in range(2):
        again, sent2, secs = _run(agg, xs)
        check(torch.equal(again, out) and sent2 == want_bytes, "repeat")
        host_s.append(secs)
    peak = torch.cuda.max_memory_allocated()
    del again

    plain = SecureAggregator(**_main_cfg(runtime=Runtime(
        kernel_impl="torch")), device=dev)
    before = ops.launch_counts()
    plain_out, plain_sent, plain_s = _run(plain, xs)
    check(ops.launch_counts() == before, "plain run launched a kernel")
    check(torch.equal(plain_out, out), "plain-version run equals kernels")
    check(plain_sent == want_bytes, "plain run bytes")
    del plain_out

    dig = SecureAggregator(**_main_cfg(wire={"transport": "digest"}),
                           device=dev)
    dig_out, dig_sent, dig_s = _run(dig, xs)
    check(torch.equal(dig_out, out), "digest: equals honest result")
    check(dig_sent == dig.cost(T_MAIN)["bytes_total"], "digest: bytes")
    del dig_out

    ranks = tuple(cl * C_MAIN + cl % C_MAIN for cl in range(N_MAIN // C_MAIN))
    flip = SecureAggregator(**_main_cfg(security={"byzantine": ByzantineSpec(
        corrupt_ranks=ranks, mode="flip")}), device=dev)
    flip_out, flip_sent, flip_s = _run(flip, xs)
    check(torch.equal(flip_out, out), "flip: equals honest result")
    check(flip_sent == want_bytes, "flip: bytes")
    del flip_out
    return ({"phase": "main", "n_nodes": N_MAIN, "T": T_MAIN,
             "equal_reference": True, "equal_plain_run": True,
             "bytes_sent": want_bytes, "launches": launches,
             "allreduce_s": host_s, "plain_allreduce_s": plain_s,
             "digest_s": dig_s, "flip_s": flip_s,
             "peak_mem_bytes": peak}, launches)


def phase_batched(rng, dev) -> dict:
    from repro_torch import SecureAggregator, Security, Topology
    from repro_torch.core.masking import reference_aggregate
    from repro_torch.kernels.secure_agg import ops
    S, n, T = 64, 16, 1 << 16
    agg = SecureAggregator(topology=Topology(n_nodes=n, cluster_size=4),
                           security=Security(redundancy=3), device=dev)
    xs = torch.from_numpy(rng.standard_normal((S, n, T), np.float32)
                          * 0.3).to(dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = agg.allreduce_batched(xs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(tuple(out.shape) == (S, T), f"batched shape {out.shape}")
    check(min(launches.values()) >= 1, f"batched launches {launches}")
    check(agg.stats()["bytes_sent"] == S * agg.cost(T)["bytes_total"],
          "batched: bytes")
    mcfg = agg.cfg.mask_cfg()
    for s in range(S):
        check(torch.equal(out[s], reference_aggregate(mcfg, xs[s])),
              f"batched session {s} equals its plain sum")
    return {"phase": "batched", "S": S, "n_nodes": n, "T": T,
            "equal_reference": True, "launches": launches, "seconds": secs,
            "bytes_sent": agg.stats()["bytes_sent"]}


def _network_exchanges(r: int) -> int:
    return sum(len(range(p % 2, r - 1, 2)) for p in range(r))


def phase_timing(rng, dev, xs) -> tuple[dict, dict]:
    """Kernel and plain-version times at the main path's shapes, with the
    least time the card could take for the same work."""
    from repro_torch.core.plan import AggConfig
    from repro_torch.kernels.secure_agg import ops
    mcfg = AggConfig(n_nodes=N_MAIN, cluster_size=C_MAIN).mask_cfg()
    B, T = N_MAIN, T_MAIN
    N = B * T
    x = xs.reshape(B, T)
    nids = torch.arange(B, dtype=torch.int32, device=dev)
    seeds = torch.full((B,), mcfg.seed, dtype=torch.int32, device=dev)
    offs = torch.zeros(B, dtype=torch.int32, device=dev)
    agg = words(rng, (B, T), dev)
    r = 3
    copies = [words(rng, (N,), dev) for _ in range(r)]
    acc = words(rng, (N,), dev)

    def mask(impl):
        return lambda: ops.mask_encrypt_batch_fn(
            x, nids, seeds, mcfg.scale, mcfg.clip, mode="mask",
            offsets=offs, cluster_size=C_MAIN, impl=impl)

    def unmask(impl):
        return lambda: ops.unmask_decrypt_batch_fn(
            agg, N_MAIN, seeds, mcfg.scale, mode="mask", offsets=offs,
            impl=impl)

    def vote(impl):
        return lambda: ops.vote_combine_fn(copies, acc, impl=impl)

    # (integer, float) operations each function needs: per-row key
    # derivation (2 splitmix + xor + mul + xor) is counted once per row
    # and key; the mask's float work is clip (2), scale and round
    key_ops = 2 * SPLITMIX_OPS + 3
    work = {
        "mask_encrypt": (8 * N + 12 * B,
                         N * (PAD_OPS + 1) + B * key_ops, N * 4, mask),
        "unmask_decrypt": (8 * N + 8 * B,
                           N * N_MAIN * (PAD_OPS + 1) + B * N_MAIN * key_ops,
                           N * 4, unmask),
        "vote_combine": (4 * (r + 2) * N,
                         N * (2 * _network_exchanges(r) + 1), 0, vote),
    }
    out = {}
    for name, (nbytes, int_ops, float_ops, fn) in work.items():
        kernel_ms = cuda_ms(fn(None), reps=10)
        plain_ms = cuda_ms(fn("torch"), reps=3)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # integers go through their half-rate pipe; all operations share
        # the lane issue rate
        ops_ms = max(int_ops / INT32_OPS_PER_S,
                     (int_ops + float_ops) / LANE_OPS_PER_S) * 1e3
        out[name] = {"ms": kernel_ms, "plain_ms": plain_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations",
                     "bytes": nbytes, "int_ops": int_ops,
                     "float_ops": float_ops,
                     "bytes_ms": bytes_ms, "operations_ms": ops_ms,
                     "library_ms": None}
    del agg, copies, acc
    return {"phase": "timing", "shapes": {"rows": B, "T": T, "r": r},
            "kernels": out, "allreduce": _time_allreduce(xs, dev),
            "nvidia_smi": smi_line()}, out


def _time_allreduce(xs, dev) -> dict:
    """Host-clock median of the full-width allreduce, and one profiled
    call: device time by kernel name and the device's busy share."""
    from repro_torch import SecureAggregator
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    agg = SecureAggregator(**_main_cfg(), device=dev)
    agg.allreduce(xs)
    host = [_run(agg, xs)[2] for _ in range(3)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agg.allreduce(xs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # operators repeat their
            continue                           # kernels' device time
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((ev.key[:80], dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"host_s": host, "median_s": statistics.median(host),
            "profiled_wall_s": wall, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3),
            "by_kernel_ms": rows[:12]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    emit(phase_device())            # always first: raises without a card
    from repro_torch.kernels.secure_agg import ops
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    if "build" in phases:
        emit(phase_build())
    errs = {k.name: 0.0 for k in ops.KERNELS}
    if "kernels" in phases:
        emit(phase_kernels(rng, dev, errs))
    launches, timing = {}, {}
    if {"main", "timing"} & set(phases):
        xs = torch.from_numpy(rng.standard_normal((N_MAIN, T_MAIN),
                                                  np.float32) * 0.3).to(dev)
    if "main" in phases:
        from repro_torch.core.masking import reference_aggregate
        from repro_torch.core.plan import AggConfig
        mcfg = AggConfig(n_nodes=N_MAIN, cluster_size=C_MAIN).mask_cfg()
        ref = reference_aggregate(mcfg, xs)
        line, launches = phase_main(xs, ref, dev)
        del ref
        emit(line)
    if "batched" in phases:
        emit(phase_batched(rng, dev))
    if "timing" in phases:
        line, timing = phase_timing(rng, dev, xs)
        emit(line)

    kernels = []
    for k in ops.KERNELS:
        t = timing.get(k.name, {})
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches.get(k.name, 0),
            "max_abs_err": errs[k.name], "ms": t.get("ms"),
            "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
            "bound_by": t.get("bound_by"), "library_ms": None})
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
