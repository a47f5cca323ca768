"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--phases device,build,kernels,...]

Phases, in order; each prints one JSON line and any failure ends the run
with a non-zero exit code:

  device   the card's name, and its name and power limit from nvidia-smi
  build    build the CUDA kernels from ``src/repro_torch/csrc`` into one
           library (one nvcc per source, started together, then a link)
  kernels  each CUDA kernel against its plain torch version on the card,
           bit for bit, over lengths, modes, counter offsets near 2^32
           and vote copies with and without a majority; the Montgomery
           multiply at L in {8, 32, 128, 256} limbs and 1..1024 rows with
           edge operands (some also against Python ints), at odd L of
           513 and 1021 (past the ladder's 511) in batches 1 and 7, and
           ``modexp_ints`` against ``pow`` at L = 128; the one-launch
           ladder ``mont_exp`` against the plain ladder and ``pow`` at L
           in {8, 32, 128, 256} and an odd L in batches 1, 7, 58, and at
           L = 128 with exponents of 0, 1, 64 and (against ``pow``) 2,374
           bits; flash
           attention in float32 (the CUDA-core kernel) and bf16 (the
           tensor-core kernel) (GQA groups 1, 2, 8, causal or not, window
           128, Sq = Skv in {77, 512, 2048}, Sq != Skv, qwen3's prefill
           shape) and the SSD scan (the kernel tests' shapes, S ragged
           against the kernel's 256-row chunk and S below one chunk, N
           in {8, 13, 128}, mamba2's prefill shape with B and C shared)
           within FLASH_TOL / SSD_TOL of their plain versions
  main     the secure allreduce at full width -- n = 64 nodes, clusters
           of 4, ring schedule, r = 3, global masking, T = 2^22 float32
           per node -- through ``SecureAggregator.allreduce`` on the card:
           equal to the plain reference sum and to the plain-version run,
           executed wire bytes equal to ``cost``, kernel launch counts;
           then the digest transport and a flip adversary
  batched  ``allreduce_batched`` with S = 64 sessions of n = 16, T = 2^16
  service  the multi-session service on the card.  (a) the steady
           stream: 256 sessions of T = 2^16 a node at the main cell's
           protocol (n = 64, c = 4, ring, r = 3, global masking), batches
           of 16 rows, 4 GiB of contributions, sealed and pumped through
           the admission queue at depth 2 (the launch counts are read on
           this run: 1 / 15 / 1 a batch), then at depth 1 and on the
           plain versions -- every session equal across the three, a
           sample equal to a one-shot ``allreduce`` of its payload and
           seed, wire bytes equal to ``cost`` times the rows; sessions/s,
           the stage means of the obs registry, peak memory and the busy
           share of one profiled batch.  (b) mixed traffic: T in {1,000;
           5,000; 2^16; 2^20} with rows of 2^16 (the 2^20 session chunks
           across 16 rows and equals the monolithic allreduce bit for
           bit), pairwise-masked and digest sessions under their own
           batch keys, a Byzantine flip and an epoch advance while
           sessions are queued.  (c) dispatch chaos at p = 0.35 under
           seeds 0, 1, 2 and a poison session bisected out, at n = 8, T =
           16, S = 8, on the card and on the CPU: equal dead letters,
           quarantines and TickClock trace sha256, every revealed session
           equal to the fault-free run
  mesh     the distributed transports: 16 rank processes on the card over
           a gloo group (every wire staged through pinned host memory,
           the kernels in every rank), after the parent's port sim on the
           card: (a) ``SecureAggregator`` on the ``mesh`` backend at n =
           16, c = 4, ring, r = 3, global masking, T = 2^22 a node, each
           rank's row equal to the sim's by sha256, within the
           quantization bound of the plain sum, executed bytes equal to
           ``cost``, launches 1 / 3 / 1; (b) the ``manual`` backend on a
           rank-local dict of 2^22 elements in 64 chunks; (c) the digest
           transport with flips on nodes 0, 4, 8, 12, exact, and with
           flips on two members of every cluster (past what r = 3
           absorbs), equal to the sim under the same flips and unequal
           to the honest sum, which shows the flips reach the ranks; (d)
           ``allreduce_batched`` of S = 16 sessions of T = 2^16 by the
           distributed reveal; (e) the service on the mesh transport,
           every rank its own copy over the same calls: 4 batches of 16
           sessions of T = 2^16 at depth 2, every rank's rows equal to the
           parent's sim service by sha256, a hop fault recovered bit for
           bit, and dispatch chaos on the mesh tripping the breaker so the
           batch runs degraded on the sim; the slowest rank's seconds a
           batch.  Medians of 5 warm runs of (a) and (b) as
           the slowest rank's wall ms, each rank's wire ms and profiled
           kernel ms, peak memory per rank
  paillier threshold Paillier at full width (1024-bit n, fixed committed
           safe primes): 512 encrypted votes summed, partial decryption
           of c_t = 69 shares' first 58 on the card equal to Python
           ``pow`` and combined to the sum, with one ``mont_exp`` launch
           (the ladder) and one ``mont_mul`` (leaving the Montgomery
           domain); then the paper's DA protocol over a 512-node overlay
           with Step 4 on the card, exact and equal in every account to
           the ``pow`` run
  serve    ``repro_torch.launch.serve.serve`` at full width for
           qwen3-1.7b and mamba2-370m (bf16, random weights from the
           seed): batch 4, prompt 2048, 32 tokens; prefill seconds, decode
           tokens/s, peak memory; exactly 28 ``flash_attention`` / 48
           ``ssd`` launches in the prefill and none in decode; a float32
           prefill through the kernels against the plain versions (last
           logits within LOGIT_TOL_F32); the bf16 run on the plain
           versions (its logit error and token agreement); the config
           widths against the reference's config files
  timing   CUDA-event medians of each kernel and its plain version at
           the main paths' shapes (the Montgomery multiply at the
           decryption's rows x 128 limbs and at 1056 x 128; the ladder at
           the decryption's rows, 128 limbs and exponent bits, beside the
           host loop of two ``mont_mul`` launches a bit it replaced, in
           turns, and its plain version once, held equal to it; flash
           attention and the SSD scan at the two models' prefill shapes,
           with ``scaled_dot_product_attention`` timed beside flash
           attention as the library yardstick), and the end-to-end
           allreduce time

The last lines are the card's name and power limit, one JSON object
describing every kernel (``max_abs_err`` from the kernels phase,
``launches`` on its phase's path, ``mesh_launches_per_rank`` in the mesh
phase's (a), ``service_launches`` on the service phase's depth-2 stream;
each null where its phase did not run), and ``{"ok": true, "device": {...}}``.  Without
a CUDA device the script fails before printing any result.  Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

PHASES = ("device", "build", "kernels", "main", "batched", "service",
          "mesh", "paillier", "serve", "timing")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
# 32-bit lane operations issued per second: 132 SMs x 128 lanes x
# 1.98 GHz, half the 67 TFLOP/s float32 FMA rate (an FMA counts two FLOPs)
LANE_OPS_PER_S = 67e12 / 2
# 32-bit integer add, logical, shift and multiply on sm_90: 64 results
# per clock per SM, half the lane rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9
F32_FLOPS_PER_S = 67e12       # float32 FMA outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # dense bf16 on the tensor cores
# float32 products on the tensor cores in 3xTF32: three TF32 products
# (495 TFLOP/s dense) for each float32 one
F32_3XTF32_FLOPS_PER_S = 495e12 / 3
N_MAIN, C_MAIN, T_MAIN = 64, 4, 1 << 22
# mesh: one rank process per node of n = 16 on the one card (the
# reference's selftest size); (a)'s payload is the main cell's width, (b)
# chunks it at 2^16, (d) is S sessions of T_batch; (c) flips MESH_FLIP,
# one member a cluster, which the vote absorbs, and MESH_FLIP_OVER, two
# members a cluster, which it cannot
N_MESH = 16
MESH_SHAPE = {"T": 1 << 22, "chunk": 1 << 16, "S": 16, "T_batch": 1 << 16,
              "runs": 5, "svc_S": 16, "svc_T": 1 << 16, "svc_batches": 4,
              "svc_pool": 1 << 22}
MESH_FLIP = (0, 4, 8, 12)
MESH_FLIP_OVER = (0, 1, 4, 5, 8, 9, 12, 13)
SPLITMIX_OPS = 9              # add, 3 shifts, 3 xors, 2 multiplies
PAD_OPS = SPLITMIX_OPS + 2    # ctr ^ k1, then + k2
# Two 512-bit safe primes, drawn once with the port's gen_safe_prime and
# checked with _is_probable_prime (p, q and (p-1)/2, (q-1)/2), so the
# full-width key's shapes are the same in every run
P_FULL = int("111531299176384119993107029701011476323755920436567491832802"
             "959801994646988251383599881439615493711226029845013473845590"
             "00205001755194658642705468360451339")
Q_FULL = int("878186117668736310300858909383076763157932463076984285209715"
             "629955658355845996269498822573048365775560191735401017213724"
             "2788396693560907591948552415465603")
N_OVERLAY, TAU_OVERLAY, KEY_BITS = 512, 0.3, 1024
C_THRESHOLD = 69              # threshold cluster of build_overlay(512, 0.3, 0)
N_DECRYPT = 58                # decryptors of a threshold decryption
# exponent bits of 2 Delta s_i at c_t = 69 and 1024-bit n (a share lies
# below n m): the ladder's length when the paillier phase does not run
DECRYPT_BITS = 1 + (math.factorial(C_THRESHOLD)).bit_length() + 2046
# serve: the repo's prefill_32k / decode_32k shapes cut in traffic, not in
# width, to fit one run beside the other phases
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
# widths of the reference's config files (src/repro/configs/qwen3_1p7b.py,
# mamba2_370m.py), hard-coded: this script imports nothing of the package
REFERENCE_WIDTHS = {
    "qwen3-1.7b": dict(d_model=2048, n_heads=16, n_kv_heads=8, hd=128,
                       d_ff=6144, vocab_size=151936, n_units=28, ssm=None,
                       qk_norm=True, tie_embeddings=True,
                       rope_theta=1_000_000.0, dtype="bfloat16"),
    "mamba2-370m": dict(d_model=1024, n_heads=16, n_kv_heads=16, hd=64,
                        d_ff=0, vocab_size=50280, n_units=48,
                        ssm=dict(d_state=128, d_conv=4, expand=2,
                                 head_dim=64, chunk=256),
                        tie_embeddings=True, dtype="bfloat16"),
}
SERVE_KERNEL = {"qwen3-1.7b": "flash_attention", "mamba2-370m": "ssd"}
# Tolerances of the float kernels against their plain versions on the
# card (max |a - b| <= atol + rtol |b|).  Flash attention: 1e-5 in float32
# -- both compute in float32, but the kernel's online softmax rescales its
# sums once per kv tile (up to 32 at S = 2048) and adds in another order
# than cuBLAS; 2e-2 in bf16, one bf16 rounding of the output (the kernel
# tests' tolerance).  SSD: the kernel tests' 5e-4 / 1e-3 (chunks of 256
# in the kernel, of the caller's chunk in the plain version, products in
# 3xTF32 on the tensor cores: other sums, at float32 accuracy).
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SSD_TOL = (5e-4, 1e-3)
# the full-width float32 prefill: last-position logits (of unit scale)
# through the kernels against the plain versions, after 28 or 48 layers
# whose residual streams carry the kernels' float32 rounding differences
LOGIT_TOL_F32 = 2e-3


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
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.lib()
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "compiled": build.build_seconds is not None,
            "library": build.library_path().name,
            "sources": [src.name for src in build.SOURCES],
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
        if T >= 8:
            checks += _check_nonfinite(x, seeds, scale, clip, errs)
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
    checks += _check_mont_mul(rng, dev, errs)
    flash = _check_flash(rng, dev, errs)
    ssd = _check_ssd(rng, dev, errs)
    torch.cuda.synchronize()
    return {"phase": "kernels", "checks": checks + flash + ssd,
            "equal": True, "flash_attention_checks": flash,
            "ssd_checks": ssd, "allow_tf32": False,
            "flash_tol": {str(k): v for k, v in FLASH_TOL.items()},
            "ssd_tol": SSD_TOL, "max_abs_err": errs}


def _check_nonfinite(x, seeds, scale: float, clip: float, errs: dict
                     ) -> int:
    """NaN, +-Inf and -0.0 elements, in every encrypt mode: the kernel
    equals its plain version on the card, and a NaN quantizes as 0 does
    (the reference's XLA conversion sends NaN to 0)."""
    from repro_torch.kernels.secure_agg import ops
    edge = torch.tensor([math.nan, math.inf, -math.inf, -0.0, math.nan,
                         0.25, math.nan, 0.0], device=x.device)
    x = x.clone()
    x[:, :8] = edge
    zeroed = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    checks = 0
    for mode, c, nids in (("mask", 0, [3, 9]), ("quantize", 0, [0, 1]),
                          ("pairwise", 4, [6, 13])):
        def enc(v, impl=None):
            return ops.mask_encrypt_batch_fn(v, nids, seeds, scale, clip,
                                             mode=mode, cluster_size=c,
                                             impl=impl)
        got = enc(x)
        want = enc(x, "torch")
        errs["mask_encrypt"] = max(errs["mask_encrypt"],
                                   max_abs_err(got, want))
        check(torch.equal(got, want), f"mask_encrypt NaN/Inf mode={mode}")
        check(torch.equal(got, enc(zeroed)), f"NaN quantizes to 0 ({mode})")
        if mode == "quantize":
            check(got[:, :8].tolist() == [[0, int(clip * scale),
                                           -int(clip * scale), 0, 0,
                                           int(0.25 * scale), 0, 0]] * 2,
                  "quantize of NaN / Inf / -0.0")
        checks += 2
    return checks


def within(got: torch.Tensor, want: torch.Tensor, atol: float,
           rtol: float) -> bool:
    g, w = got.double(), want.double()
    return bool(torch.isfinite(g).all()) and \
        bool(((g - w).abs() <= atol + rtol * w.abs()).all())


# (B, Sq, Skv, H, K, hd, causal, window): the kernel tests' shapes, then
# GQA groups 1, 2 and 8, causal or not, window 128, Sq = Skv in {77, 512,
# 2048}, Sq != Skv both ways (a window chunk past the keys leaves rows with
# no allowed key), and qwen3-1.7b's prefill
FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, True, 0), (1, 128, 128, 2, 2, 32, False, 0),
    (1, 512, 512, 4, 1, 64, True, 128), (2, 128, 384, 2, 1, 32, True, 0),
    (1, 256, 256, 8, 8, 16, True, 0),
    (2, 77, 77, 8, 8, 128, True, 0), (2, 77, 77, 8, 4, 128, False, 0),
    (2, 77, 77, 8, 1, 128, True, 128), (2, 512, 512, 16, 16, 128, False, 0),
    (2, 512, 512, 16, 8, 128, True, 128), (1, 512, 512, 16, 2, 128, True, 0),
    (1, 2048, 2048, 16, 8, 128, True, 0), (1, 2048, 2048, 8, 1, 128, False, 0),
    (1, 2048, 2048, 16, 16, 128, True, 128), (2, 200, 77, 4, 2, 64, True, 64),
    (4, 2048, 2048, 16, 8, 128, True, 0),
]


def _check_flash(rng, dev, errs: dict) -> int:
    """``flash_attention`` against its plain version on the card."""
    from repro_torch.kernels.flash_attention import flash_attention
    checks = 0
    by_dtype = errs.setdefault("flash_attention_by_dtype", {})
    for B, Sq, Skv, H, K, hd, causal, window in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (B, S, n, hd), np.float32)).to(dev, dtype)
                for S, n in ((Sq, H), (Skv, K), (Skv, K)))
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention(q, k, v, causal=causal, window=window,
                                   impl="torch")
            err = max_abs_err(got.float(), want.float())
            errs["flash_attention"] = max(errs["flash_attention"], err)
            by_dtype[str(dtype)] = max(by_dtype.get(str(dtype), 0.0), err)
            tol = FLASH_TOL[dtype]
            check(got.dtype == dtype and within(got, want, tol, tol),
                  f"flash_attention {dtype} B={B} Sq={Sq} Skv={Skv} H={H} "
                  f"K={K} hd={hd} causal={causal} window={window}: max err "
                  f"{max_abs_err(got.float(), want.float())}")
            checks += 1
    return checks


def _ssd_inputs(rng, dev, *shape_x, N: int, per_head: bool):
    """Random SSD inputs: x, dt (0.1 |N(0, 1)|), a or A (negative), B, C;
    per head (BH, S, ...) or in the model's layout (B, S, H, ...)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    x = rng.standard_normal(shape_x, np.float32)
    dt = np.abs(rng.standard_normal(shape_x[:-1], np.float32)) * 0.1
    if per_head:
        BH, S, _ = shape_x
        a = -np.abs(rng.standard_normal(BH, np.float32))
        bc = (BH, S, N)
    else:
        Bsz, S, H, _ = shape_x
        a = -np.linspace(1.0, 16.0, H, dtype=np.float32)
        bc = (Bsz, S, N)
    return (t(x), t(dt), t(a), t(rng.standard_normal(bc, np.float32)),
            t(rng.standard_normal(bc, np.float32)))


def _check_ssd(rng, dev, errs: dict) -> int:
    """``ssd`` (the Pallas signature) and ``ssd_chunked`` (the model's
    form) against their plain versions on the card; at the kernel tests'
    small shapes also against the sequential ``ssd_ref``."""
    from repro_torch.kernels.ssd import ssd, ssd_chunked, ssd_ref
    atol, rtol = SSD_TOL
    checks = 0

    def hold(got, want, what):
        nonlocal checks
        for g, w, part in zip(got, want, ("y", "state")):
            errs["ssd"] = max(errs["ssd"], max_abs_err(g, w))
            check(within(g, w, atol, rtol),
                  f"ssd {what} {part}: max err {max_abs_err(g, w)}")
        checks += 1

    # the kernel tests' shapes; then S ragged against the kernel's chunk of
    # 256 (over two and three chunks) and below one chunk, N in {8, 13,
    # 128} (13: rows of B and C off 16-byte boundaries)
    for BH, S, P, N, chunk in ((4, 256, 64, 32, 64), (2, 128, 32, 16, 128),
                               (8, 512, 64, 64, 128), (1, 64, 16, 8, 32),
                               (3, 77, 64, 128, 64), (2, 200, 16, 128, 128),
                               (2, 520, 32, 8, 128), (3, 700, 64, 128, 128),
                               (2, 40, 64, 8, 32), (2, 300, 16, 13, 100)):
        args = _ssd_inputs(rng, dev, BH, S, P, N=N, per_head=True)
        got = ssd(*args, chunk=chunk)
        hold(got, ssd(*args, chunk=chunk, impl="torch"),
             f"BH={BH} S={S} P={P} N={N}")
        if S <= 512:
            hold(got, ssd_ref(*args), f"BH={BH} S={S} vs sequential")
    for Bsz, S, H, P, N in ((2, 200, 4, 64, 128), (2, 77, 8, 32, 64),
                            (2, 600, 8, 64, 8), (1, 300, 4, 16, 13),
                            (4, 2048, 32, 64, 128)):
        args = _ssd_inputs(rng, dev, Bsz, S, H, P, N=N, per_head=False)
        chunk = min(256, S)
        hold(ssd_chunked(*args, chunk),
             ssd_chunked(*args, chunk, impl="torch"),
             f"model form B={Bsz} S={S} H={H} P={P} N={N}")
    return checks


def _rand_below(rng, n: int) -> int:
    return int.from_bytes(rng.bytes((n.bit_length() + 7) // 8 + 8),
                          "little") % n


def _check_mont_mul(rng, dev, errs: dict) -> int:
    """``mont_mul`` against its plain version on the card, limb for limb,
    and ``modexp_ints`` against Python ``pow``."""
    from repro_torch.crypto.limb import (batch_to_limbs, limbs_needed,
                                         montgomery_params)
    from repro_torch.kernels.modmul import ops as mm
    from repro_torch.kernels.modmul.ref import mont_mul_int
    checks = _check_mont_exp(rng, dev, errs)
    for L in (8, 32, 128, 256):
        n = _rand_below(rng, 1 << (16 * L - 3)) | (1 << (16 * L - 4)) | 1
        check(limbs_needed(n) == L, f"modulus of {L} limbs")
        mp = montgomery_params(n, L)
        nl = torch.from_numpy(mp["n_limbs"].astype(np.int32)).to(dev)
        edges = [0, 1, n - 1, mp["R"] % n]
        for batch in (1, 7, 58, 1024):
            k = min(batch, len(edges))
            av = edges[:k] + [_rand_below(rng, n) for _ in range(batch - k)]
            bv = [_rand_below(rng, n) for _ in range(batch - k)] + edges[:k]
            limbs = batch_to_limbs(av + bv, L)
            a = torch.from_numpy(limbs[:batch].astype(np.int32)).to(dev)
            b = torch.from_numpy(limbs[batch:].astype(np.int32)).to(dev)
            got = mm.mont_mul_op(a, b, nl, mp["n0inv"])
            want = mm.mont_mul_op(a, b, nl, mp["n0inv"], impl="torch")
            errs["mont_mul"] = max(errs["mont_mul"], max_abs_err(got, want))
            check(torch.equal(got, want), f"mont_mul L={L} batch={batch}")
            checks += 1
            if batch <= N_DECRYPT:
                truth = mont_mul_int(limbs[:batch], limbs[batch:], n, L)
                check(np.array_equal(got.cpu().numpy(),
                                     truth.astype(np.int32)),
                      f"mont_mul L={L} batch={batch} against Python ints")
                checks += 1
    # odd L past the ladder's 511: 16-bit digits, 32 a lane
    for L in (513, 1021):
        n = _rand_below(rng, 1 << (16 * L - 3)) | (1 << (16 * L - 4)) | 1
        mp = montgomery_params(n, L)
        nl = torch.from_numpy(mp["n_limbs"].astype(np.int32)).to(dev)
        for batch in (1, 7):
            av = [0, n - 1, mp["R"] % n][:batch] + [
                _rand_below(rng, n) for _ in range(batch - min(batch, 3))]
            bv = [_rand_below(rng, n) for _ in range(batch)]
            limbs = batch_to_limbs(av + bv, L)
            a = torch.from_numpy(limbs[:batch].astype(np.int32)).to(dev)
            b = torch.from_numpy(limbs[batch:].astype(np.int32)).to(dev)
            got = mm.mont_mul_op(a, b, nl, mp["n0inv"])
            want = mm.mont_mul_op(a, b, nl, mp["n0inv"], impl="torch")
            errs["mont_mul"] = max(errs["mont_mul"], max_abs_err(got, want))
            check(torch.equal(got, want), f"mont_mul L={L} batch={batch}")
            truth = mont_mul_int(limbs[:batch], limbs[batch:], n, L)
            check(np.array_equal(got.cpu().numpy(), truth.astype(np.int32)),
                  f"mont_mul L={L} batch={batch} against Python ints")
            checks += 2
    # modexp at the decryption's width: n^2 of 2048 bits, L = 128
    n = _rand_below(rng, 1 << 2047) | (1 << 2047) | 1
    L = limbs_needed(n)
    check(L == 128, "2048-bit modulus has 128 limbs")
    exps = [0, 1, _rand_below(rng, 1 << 64) | (1 << 63),
            _rand_below(rng, 1 << 2374) | (1 << 2373)]
    bases = [_rand_below(rng, n) for _ in exps]
    got = mm.modexp_ints(bases, exps, n, L, device=dev)
    check(got == [pow(x, e, n) for x, e in zip(bases, exps)],
          "modexp_ints equals pow at L = 128")
    return checks + 1


def _ladder_inputs(n: int, L: int, xs, exps, dev):
    """Montgomery-domain bases, exponent bits and R mod n, on the card."""
    from repro_torch.crypto.limb import (batch_to_limbs, montgomery_params,
                                         to_limbs, to_mont)
    from repro_torch.kernels.modmul.ops import exponent_bits
    mp = montgomery_params(n, L)
    nbits = max(e.bit_length() for e in exps) or 1
    a = torch.from_numpy(batch_to_limbs([to_mont(x % n, mp) for x in xs], L)
                         .astype(np.int32)).to(dev)
    bits = torch.from_numpy(exponent_bits(exps, nbits)).to(dev)
    one = torch.from_numpy(to_limbs(mp["R"] % n, L).astype(np.int32)).to(dev)
    return mp, a, bits, one


def _check_mont_exp(rng, dev, errs: dict) -> int:
    """``mont_exp`` (the whole ladder in one launch) against the plain
    ladder (``impl="torch"``) limb for limb and against Python ``pow``:
    even L on 32-bit digits, an odd L on 16-bit ones, batches 1, 7, 58
    with 32-bit exponents; then the decryption's width with exponents of
    0, 1 and 64 bits, and with a 2,374-bit one against ``pow``."""
    from repro_torch.crypto.limb import batch_from_limbs
    from repro_torch.kernels.modmul import ops as mm
    checks = 0

    def hold(n, L, xs, exps, what, plain=True):
        nonlocal checks
        mp, a, bits, one = _ladder_inputs(n, L, xs, exps, dev)
        got = mm.mont_exp_op(a, bits, mp["n_limbs"], mp["n0inv"], one)
        if plain:
            want = mm.mont_exp_op(a, bits, mp["n_limbs"], mp["n0inv"], one,
                                  impl="torch")
            errs["mont_exp"] = max(errs["mont_exp"], max_abs_err(got, want))
            check(torch.equal(got, want), f"mont_exp {what}: plain ladder")
            checks += 1
        R_inv = pow(mp["R"], -1, n)
        vals = batch_from_limbs(got.cpu().numpy().astype(np.uint32))
        check([v * R_inv % n for v in vals] ==
              [pow(x, e, n) for x, e in zip(xs, exps)],
              f"mont_exp {what}: pow")
        checks += 1

    for L in (8, 32, 128, 256, 33):
        n = _rand_below(rng, 1 << (16 * L - 3)) | (1 << (16 * L - 4)) | 1
        for batch in (1, 7, 58):
            xs = [_rand_below(rng, n) for _ in range(batch)]
            exps = [0, 1][:batch] + [_rand_below(rng, 1 << 32) | 1 << 31
                                     for _ in range(batch - 2)]
            hold(n, L, xs, exps, f"L={L} batch={batch}")
    # the decryption's width; the 2,374-bit row against pow only here:
    # the plain ladder over ~2,400 bits takes ~4 min on the card, so the
    # timing phase holds it against the kernel once, at the decryption's
    # own shape
    n = _rand_below(rng, 1 << 2047) | (1 << 2047) | 1
    exps = [0, 1, _rand_below(rng, 1 << 64) | (1 << 63)]
    hold(n, 128, [_rand_below(rng, n) for _ in exps], exps,
         "L=128, exponents of 0, 1 and 64 bits")
    exps.append(_rand_below(rng, 1 << 2374) | (1 << 2373))
    hold(n, 128, [_rand_below(rng, n) for _ in exps], exps,
         "L=128, exponents of 0, 1, 64 and 2,374 bits", plain=False)
    return checks


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
    from repro_torch.kernels import backend
    agg = SecureAggregator(**_main_cfg(), device=dev)
    want_bytes = agg.cost(T_MAIN)["bytes_total"]
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    out, sent, secs = _run(agg, xs)
    launches = backend.launch_counts()
    check(launches["mask_encrypt"] >= 1 and launches["unmask_decrypt"] >= 1
          and launches["vote_combine"] >= 15, f"launches {launches}")
    launches = {k.name: launches[k.name] for k in backend.SECURE_AGG}
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
    before = backend.launch_counts()
    plain_out, plain_sent, plain_s = _run(plain, xs)
    check(backend.launch_counts() == before, "plain run launched a kernel")
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
    from repro_torch.kernels import backend
    S, n, T = 64, 16, 1 << 16
    agg = SecureAggregator(topology=Topology(n_nodes=n, cluster_size=4),
                           security=Security(redundancy=3), device=dev)
    xs = torch.from_numpy(rng.standard_normal((S, n, T), np.float32)
                          * 0.3).to(dev)
    backend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = agg.allreduce_batched(xs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = backend.launch_counts()
    check(tuple(out.shape) == (S, T), f"batched shape {out.shape}")
    check(min(launches[k.name] for k in backend.SECURE_AGG) >= 1,
          f"batched launches {launches}")
    check(agg.stats()["bytes_sent"] == S * agg.cost(T)["bytes_total"],
          "batched: bytes")
    mcfg = agg.cfg.mask_cfg()
    for s in range(S):
        check(torch.equal(out[s], reference_aggregate(mcfg, xs[s])),
              f"batched session {s} equals its plain sum")
    return {"phase": "batched", "S": S, "n_nodes": n, "T": T,
            "equal_reference": True, "launches": launches, "seconds": secs,
            "bytes_sent": agg.stats()["bytes_sent"]}


# service: (a) the steady stream at the main cell's protocol, (b) mixed
# traffic with a chunked 2^20 session, (c) resilience at the reference
# grid's small size, on the card and on the CPU
SERVICE_SHAPE = {"sessions": 256, "T": 1 << 16, "max_batch": 16,
                 "mixed_T": (1000, 5000, 1 << 16, 1 << 20),
                 "row": 1 << 16, "pool": 1 << 25}
SERVICE_CHAOS_SEEDS = (0, 1, 2)


def _pool(seed: int, size: int) -> np.ndarray:
    """A seeded float32 pool that sessions take their payloads from as
    views (distinct offsets per session and slot): the stream's 4 GiB of
    contributions without 4 GiB of draws."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(size, np.float32) * 0.3).clip(-0.95, 0.95)


def _payload(pool: np.ndarray, key: int, T: int) -> np.ndarray:
    off = (key * 40_009) % (pool.shape[0] - T)
    return pool[off:off + T]


def _open_sessions(svc, pool, count: int, T: int, *, params=None,
                   first_key: int = 0, now=None) -> list:
    n = (params or svc.default_params).n_nodes
    out = []
    for i in range(count):
        s = svc.open(params=params, now=now)
        for slot in range(n):
            s.contribute(slot, _payload(pool, (first_key + i) * n + slot, T))
        svc.seal(s.sid, now=now)
        out.append(s)
    return out


def _stream_service(dev, depth: int, T: int, max_batch: int, impl=None):
    """(a)'s service: the main cell's protocol, sessions of T."""
    from repro_torch.service import (AggregationService, BatchingConfig,
                                     SessionParams, StreamConfig)
    params = SessionParams(n_nodes=N_MAIN, elems=T, cluster_size=C_MAIN,
                           redundancy=3, schedule="ring", masking="global")
    return AggregationService(
        params, kernel_impl=impl, device=dev,
        batching=BatchingConfig(max_batch=max_batch),
        stream=StreamConfig(depth=depth))


def _run_stream(dev, pool, shape: dict, depth: int, impl=None) -> tuple:
    """(a)'s stream through a fresh service: every session opened and
    sealed, then one pump flushes the backlog as full batches (size
    watermark), ``depth`` slots in flight.  (sessions, seconds, service)."""
    svc = _stream_service(dev, depth, shape["T"], shape["max_batch"], impl)
    ss = _open_sessions(svc, pool, shape["sessions"], shape["T"])
    _sync(dev)
    t0 = time.perf_counter()
    ran = svc.pump()
    _sync(dev)
    secs = time.perf_counter() - t0
    check(ran == shape["sessions"], f"service (a): {ran} sessions ran")
    return ss, secs, svc


def _stage_means(svc) -> dict:
    from repro_torch.obs import metrics as M
    hist = svc.metrics.snapshot()["histograms"]
    return {st: hist.get(f"{M.H_STAGE}{{stage={st}}}", {}).get("mean")
            for st in M.STAGES}


def phase_service(dev, seed: int, shape: Optional[dict] = None
                  ) -> tuple[dict, dict]:
    """The multi-session service on the card: (a) the steady stream,
    (b) mixed traffic, (c) resilience against the CPU.  Returns the
    phase's line and the kernel launches of (a)'s depth-2 stream."""
    from repro_torch import SecureAggregator, Security, Topology
    from repro_torch.kernels import backend
    shape = dict(SERVICE_SHAPE if shape is None else shape)
    pool = _pool(seed, shape["pool"])
    on_card = dev.type == "cuda"
    # warm-up: one batch builds the kernels' library, the round index and
    # the pinned pools, so the timed runs see a running service
    warm = dict(shape, sessions=shape["max_batch"])
    _run_stream(dev, pool, warm, 2)

    # (a) the steady stream: depth 2 (the path the counts are read on),
    # then depth 1, then the plain versions
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    ss2, secs2, svc2 = _run_stream(dev, pool, shape, 2)
    launches = backend.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    batches = svc2.executor.batches_run
    check(batches == shape["sessions"] // shape["max_batch"],
          f"service (a): {batches} batches")
    per_batch = {k.name: launches[k.name] / batches
                 for k in backend.SECURE_AGG}
    rounds = N_MAIN // C_MAIN - 1
    if on_card:
        check(per_batch == {"mask_encrypt": 1, "unmask_decrypt": 1,
                            "vote_combine": rounds},
              f"service (a): launches per batch {per_batch}")
    cost = SecureAggregator(**_main_cfg(), device=dev).cost(shape["T"])
    wire = svc2.executor.wire_bytes
    check(wire == cost["bytes_total"] * shape["sessions"],
          f"service (a): wire bytes {wire} != cost x rows")
    stages = _stage_means(svc2)
    ss1, secs1, _ = _run_stream(dev, pool, shape, 1)
    before = backend.launch_counts()
    ssp, secsp, _ = _run_stream(dev, pool, shape, 2, impl="torch")
    check(backend.launch_counts() == before,
          "service (a): the plain-version stream launched a kernel")
    for a, b, c in zip(ss2, ss1, ssp):
        check(torch.equal(a.result, b.result),
              f"service (a): session {a.sid} depth 2 != depth 1")
        check(torch.equal(a.result, c.result),
              f"service (a): session {a.sid} kernels != plain versions")
    del ss1, ssp
    sample = ss2[::max(1, len(ss2) // 4)][:4]
    for s in sample:
        one = SecureAggregator(**_main_cfg(security={"seed": s.seed}),
                               device=dev)
        xs = torch.stack([torch.from_numpy(_payload(pool, s.sid * N_MAIN + i,
                                                    shape["T"]))
                          for i in range(N_MAIN)]).to(dev)
        check(torch.equal(one.allreduce(xs)[0].cpu(), s.result),
              f"service (a): session {s.sid} != one-shot allreduce")
    del ss2, svc2

    # one profiled warm batch: the device's busy share
    svc = _stream_service(dev, 2, shape["T"], shape["max_batch"])
    _open_sessions(svc, pool, shape["max_batch"], shape["T"])
    svc.pump()
    _open_sessions(svc, pool, shape["max_batch"], shape["T"])
    prof = (profile_device(lambda: svc.pump(), parts=(
        "::mask_kernel", "::vote_kernel", "::unmask_kernel", "Memcpy"))
        if on_card else None)
    del svc

    mixed = _phase_service_mixed(dev, pool, shape)
    chaos = _phase_service_chaos(dev)
    T, S = shape["T"], shape["sessions"]
    line = {"phase": "service", "n_nodes": N_MAIN, "T": T, "sessions": S,
            "max_batch": shape["max_batch"],
            "contribution_bytes": 4 * S * N_MAIN * T,
            "sessions_per_s": {"depth2": S / secs2, "depth1": S / secs1,
                               "plain_depth2": S / secsp},
            "pump_s": {"depth2": secs2, "depth1": secs1,
                       "plain_depth2": secsp},
            "stage_mean_s": stages, "launches_per_batch": per_batch,
            "wire_bytes": wire, "peak_mem_bytes": peak,
            "equal_plain": True, "equal_depth1": True,
            "equal_one_shot": [s.sid for s in sample],
            "profiled_batch": None if prof is None else {
                "wall_ms": prof["profiled_wall_s"] * 1e3,
                "device_busy_ms": prof["device_busy_ms"],
                "device_busy_share": prof["device_busy_share"],
                "by_part": prof["by_part"],
                "by_kernel_ms": prof["by_kernel_ms"][:8]},
            "mixed": mixed, "chaos": chaos}
    return line, {k.name: launches[k.name] for k in backend.KERNELS}


def _phase_service_mixed(dev, pool, shape: dict) -> dict:
    """(b): sessions of every length in ``mixed_T`` (the longest chunked
    across rows of ``row``), pairwise-masked and digest-transport
    sessions under their own batch keys, a Byzantine flip injected into
    a session in flight and an epoch advance (joins) while sessions are
    queued.  Every session ends revealed within the quantization bound
    of its plain sum; the chunked session equals the monolithic one-shot
    allreduce bit for bit."""
    import dataclasses as dc
    from repro_torch import SecureAggregator
    from repro_torch.core.masking import quantization_error_bound
    from repro_torch.core.overlay import build_overlay
    from repro_torch.runtime.fault import SessionFaultPlan
    from repro_torch.service import (AggregationService, BatchingConfig,
                                     EpochManager, SessionParams,
                                     StreamConfig)
    em = EpochManager(build_overlay(1024, 0.2, seed=3), cluster_size=C_MAIN,
                      n_clusters=N_MAIN // C_MAIN)
    base = SessionParams(n_nodes=N_MAIN, elems=shape["mixed_T"][0],
                         cluster_size=C_MAIN, redundancy=3)
    svc = AggregationService(
        base, epochs=em, device=dev, stream=StreamConfig(depth=2),
        batching=BatchingConfig(max_batch=shape["max_batch"],
                                max_row_elems=shape["row"],
                                pad_buckets=(1024, 4096, 16384, 65536)))
    kinds = []
    for T in shape["mixed_T"]:
        kinds.append(("global", dc.replace(base, elems=T)))
    kinds.append(("pairwise", dc.replace(base, elems=shape["mixed_T"][1],
                                         masking="pairwise", clip=1.0)))
    kinds.append(("digest", dc.replace(base, elems=shape["mixed_T"][2],
                                       transport="digest")))
    sessions, key = [], 0
    epoch0 = em.current().epoch
    for rep in range(2):
        for name, params in kinds:
            (s,) = _open_sessions(svc, pool, 1, params.elems, params=params,
                                  first_key=key)
            key += 1
            sessions.append((name, s))
        if rep == 0:
            # in flight: a Byzantine flip on one member of one cluster of
            # a sealed session, then an epoch advance
            sessions[0][1].inject_fault(SessionFaultPlan(byzantine_slots=(1,)))
            em.churn(joins=8)
    check(em.current().epoch == epoch0 + 1, "service (b): epoch advance")
    check(sessions[-1][1].epoch.epoch == epoch0 + 1
          and sessions[0][1].epoch.epoch == epoch0,
          "service (b): sessions pinned to their epochs")
    _sync(dev)
    t0 = time.perf_counter()
    ran = svc.drain()
    _sync(dev)
    secs = time.perf_counter() - t0
    check(ran == len(sessions), f"service (b): {ran} of {len(sessions)} ran")
    errs = {}
    for name, s in sessions:
        check(s.state.value == "revealed", f"service (b): {name} {s.sid}")
        n = s.params.n_nodes
        xs = np.stack([_payload(pool, s.sid * n + i, s.params.elems)
                       for i in range(n)])
        mcfg = s.params.agg_config().mask_cfg()
        err = float(np.abs(s.result.numpy().astype(np.float64)
                           - xs.astype(np.float64).sum(0)).max())
        check(err <= 4 * quantization_error_bound(mcfg),
              f"service (b): {name} session {s.sid} err {err}")
        errs[f"{name}:{s.params.elems}"] = max(errs.get(
            f"{name}:{s.params.elems}", 0.0), err)
    big = [s for name, s in sessions if s.params.elems == max(
        shape["mixed_T"])]
    rows = big[0].n_rows(shape["row"])
    for s in big:
        one = SecureAggregator(**_main_cfg(security={"seed": s.seed}),
                               device=dev)
        xs = torch.stack([torch.from_numpy(_payload(
            pool, s.sid * N_MAIN + i, s.params.elems))
            for i in range(N_MAIN)]).to(dev)
        check(torch.equal(one.allreduce(xs)[0].cpu(), s.result),
              f"service (b): chunked session {s.sid} != monolithic")
    return {"sessions": len(sessions), "seconds": secs,
            "chunked_rows": rows, "chunked_equal_monolithic": True,
            "batch_sizes": list(svc.queue.batch_sizes),
            "flip_absorbed": True, "epochs": [epoch0, epoch0 + 1],
            "max_err_by_kind": errs}


def _chaos_service(dev, seed: Optional[int], poison: bool, sink):
    """(c)'s service at the reference grid's size, traced under a
    TickClock into ``sink``."""
    from repro_torch.obs import TickClock, TraceRecorder
    from repro_torch.runtime.chaos import ChaosConfig
    from repro_torch.runtime.resilience import RetryPolicy
    from repro_torch.service import (AggregationService, BatchingConfig,
                                     SessionParams)
    chaos = None
    if poison:
        chaos = ChaosConfig(mode="dispatch", poison_sids=(3,))
    elif seed is not None:
        chaos = ChaosConfig(mode="dispatch", p=0.35, seed=seed)
    return AggregationService(
        SessionParams(n_nodes=8, elems=16, cluster_size=4, redundancy=3),
        batching=BatchingConfig(max_batch=4, max_age=1e9),
        retry=RetryPolicy(max_attempts=2, base_backoff_s=0),
        chaos=chaos, device=dev,
        recorder=TraceRecorder(clock=TickClock(), sink=sink))


def _phase_service_chaos(dev) -> dict:
    """(c): dispatch chaos at p = 0.35 under seeds 0, 1, 2 and a poison
    session bisected out, each on the card and on the CPU: the dead
    letters, the quarantines and the TickClock JSONL's sha256 equal, and
    every revealed session equal to the fault-free run."""
    import io
    from repro_torch.runtime.chaos import ChaosError
    vals = (np.random.default_rng(23).standard_normal((8, 8, 16), np.float32)
            * 0.3)

    def run(d, seed, poison):
        buf = io.StringIO()
        svc = _chaos_service(d, seed, poison, buf)
        ss = []
        for i in range(8):
            s = svc.open(now=0.0)
            for slot in range(8):
                s.contribute(slot, vals[i, slot])
            svc.seal(s.sid, now=0.0)
            ss.append(s)
        try:
            svc.drain()
        except ChaosError:
            pass
        svc.recorder.close()
        return (ss, svc.executor.dead_letter,
                svc.stats["resilience"]["quarantined"],
                hashlib.sha256(buf.getvalue().encode()).hexdigest())

    cpu = torch.device("cpu")
    clean, _, _, _ = run(dev, None, False)
    out = {}
    for seed, poison in [(s, False) for s in SERVICE_CHAOS_SEEDS] + \
            [(None, True)]:
        card = run(dev, seed, poison)
        host = run(cpu, seed, poison)
        name = "poison" if poison else f"seed{seed}"
        check(card[1] == host[1], f"service (c) {name}: dead letters")
        check(card[2] == host[2], f"service (c) {name}: quarantines")
        check(card[3] == host[3], f"service (c) {name}: trace sha256")
        for a, b, c in zip(card[0], host[0], clean):
            check(a.state.value == b.state.value,
                  f"service (c) {name}: states")
            if a.state.value == "revealed":
                check(torch.equal(a.result, c.result)
                      and torch.equal(b.result, c.result),
                      f"service (c) {name}: session {a.sid} != fault-free")
        if poison:
            check([sid for sid, _ in card[1]] == [3],
                  "service (c): the poison session alone quarantined")
        out[name] = {"dead_letter": [sid for sid, _ in card[1]],
                     "quarantined": card[2], "trace_sha256": card[3]}
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _mesh_cfg(**kw):
    """The mesh phase's config: the main cell's protocol at n = 16."""
    from repro_torch import AggConfig
    return AggConfig(n_nodes=N_MESH, cluster_size=C_MAIN, redundancy=3,
                     schedule="ring", masking="global", **kw)


def _mesh_inputs(seed: int, dev, shape: dict) -> tuple:
    """(a)'s per-node payloads, (b)'s per-node trees (as rows), (d)'s
    sessions: drawn from ``seed`` on ``dev``, so the parent and every rank
    hold the same bits; uniform within 0.9 of the clip, so the plain sum
    is the quantized sum's yardstick."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def draw(*sz):
        return (torch.rand(sz, generator=g, device=dev) * 2 - 1) * 0.9

    n, T = N_MESH, shape["T"]
    return draw(n, T), draw(n, T), draw(shape["S"], n, shape["T_batch"])


def _tree_of(rows: torch.Tensor) -> dict:
    """(..., T) rows -> (b)'s dict payload: two leaves of T / 2."""
    h = rows.shape[-1] // 2
    return {"b": rows[..., h:], "w": rows[..., :h].reshape(
        rows.shape[:-1] + (h // 64, 64))}


def _tree_sha(tree: dict) -> str:
    return sha(torch.cat([tree[k].reshape(-1) for k in sorted(tree)]))


def _mesh_rank(rank: int, seed: int, job_dir: str, shape: dict) -> None:
    """One rank of the mesh phase: (a)-(d) through the facade, checked
    against the parent's sim hashes, with timings; writes
    ``rank{r}.json``.  Any failed check raises and ends the run."""
    import torch.distributed as dist
    from repro_torch import Runtime, SecureAggregator
    from repro_torch.core.byzantine import ByzantineSpec
    from repro_torch.core.engine import flat_node_id
    from repro_torch.kernels import backend
    from repro_torch.runtime.compat import node_mesh
    dev = torch.device(shape["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with open(pathlib.Path(job_dir) / "want.json") as f:
        want = json.load(f)
    mesh = node_mesh(N_MESH)
    nid = flat_node_id(mesh, ("data",))
    xa, xb, xd = _mesh_inputs(seed, dev, shape)
    rt = Runtime(backend="mesh", mesh=mesh)
    on_card = dev.type == "cuda"

    def launches():
        return backend.launch_counts()

    def timed(agg, fn) -> dict:
        walls, wires = [], {}
        for _ in range(shape["runs"]):
            dist.barrier()
            w0 = agg.stats()["wire_s"]
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
            for k, v in agg.stats()["wire_s"].items():
                wires.setdefault(k, []).append((v - w0[k]) * 1e3)
        prof = None
        if on_card:
            dist.barrier()
            kernels = ("::mask_kernel", "::vote_kernel", "::unmask_kernel")
            p = profile_device(fn, parts=(*kernels, "Memcpy"))
            # the ranks' contexts share the card by time slices, so a
            # profiled span can hold other ranks' turns: only the
            # kernels' own times and the copies are read from it
            prof = {"wall_ms": p["profiled_wall_s"] * 1e3,
                    "device_busy_ms": p["device_busy_ms"],
                    "kernel_ms": sum(p["by_part"][k]["ms"] for k in kernels),
                    "kernel_launches": {k[2:]: p["by_part"][k]["launches"]
                                        for k in kernels},
                    "copy_ms": p["by_part"]["Memcpy"]["ms"]}
            if rank == 0:
                prof["by_kernel_ms"] = p["by_kernel_ms"][:8]
        return {"wall_ms": walls, "wire_ms": wires, "profile": prof}

    out = {"rank": rank, "node": nid}
    # (a) the facade on the mesh backend at full payload width
    agg = SecureAggregator(_mesh_cfg(), runtime=rt, device=dev)
    backend.reset_launch_counts()
    got = agg.allreduce(xa)
    _sync(dev)
    out["a_launches"] = launches()
    if on_card:
        want_launches = dict.fromkeys(out["a_launches"], 0)
        want_launches.update(mask_encrypt=1, unmask_decrypt=1,
                             vote_combine=3)
        check(out["a_launches"] == want_launches,
              f"rank {rank} (a) launches {out['a_launches']}")
    check(sha(got[nid]) == want["a_rows"][nid], f"rank {rank} (a) row")
    check(sha(got) == want["a_all"], f"rank {rank} (a) gathered result")
    check(agg.stats()["bytes_sent"] == want["a_bytes"], f"rank {rank} bytes")
    del got
    out["a"] = timed(agg, lambda: agg.allreduce(xa))

    # (b) the manual backend: this rank's tree, 64 chunks
    man = SecureAggregator(_mesh_cfg(chunk_elems=shape["chunk"]),
                           runtime=Runtime(backend="manual"), device=dev)
    tree = _tree_of(xb[nid])
    backend.reset_launch_counts()
    got = man.allreduce(tree)
    _sync(dev)
    out["b_launches"] = launches()
    check(_tree_sha(got) == want["b_rows"][nid], f"rank {rank} (b) tree")
    del got
    out["b"] = timed(man, lambda: man.allreduce(tree))

    # (c) under attack: the digest transport, flips on one member a cluster
    flip = SecureAggregator(_mesh_cfg(transport="digest", byzantine=(
        ByzantineSpec(corrupt_ranks=MESH_FLIP, mode="flip"))),
        runtime=rt, device=dev)
    backend.reset_launch_counts()
    got = flip.allreduce(xa)
    _sync(dev)
    out["c_launches"] = launches()
    check(sha(got[nid]) == want["a_rows"][nid], f"rank {rank} (c) exact")
    check(flip.stats()["bytes_sent"] == want["c_bytes"], f"rank {rank} (c)")
    over = flip.derive(byzantine=ByzantineSpec(corrupt_ranks=MESH_FLIP_OVER,
                                               mode="flip"))
    got = over.allreduce(xa)
    _sync(dev)
    check(sha(got[nid]) == want["c_over_rows"][nid]
          and sha(got) == want["c_over_all"],
          f"rank {rank} (c) flips past the vote: not the sim's result")
    del got

    # (d) batched on the mesh: the distributed reveal
    backend.reset_launch_counts()
    got = agg.allreduce_batched(xd)
    _sync(dev)
    out["d_launches"] = launches()
    check(sha(got) == want["d"], f"rank {rank} (d) batched")
    del got
    out["e"] = _mesh_service_rank(rank, mesh, dev, seed, shape, want["e"])
    out["peak_mem_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if on_card else None)
    with open(pathlib.Path(job_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def _mesh_service(dev, shape: dict, **kw):
    """(e)'s service: n = N_MESH, S sessions of T a batch, depth 2."""
    from repro_torch.service import (AggregationService, BatchingConfig,
                                     SessionParams, StreamConfig)
    params = SessionParams(n_nodes=N_MESH, elems=shape["svc_T"],
                           cluster_size=C_MAIN, redundancy=3)
    return AggregationService(
        params, device=dev, stream=StreamConfig(depth=2),
        batching=BatchingConfig(max_batch=shape["svc_S"]), **kw)


def _mesh_service_rank(rank: int, mesh, dev, seed: int, shape: dict,
                       want: list) -> dict:
    """(e) in one rank: the service on the mesh transport, every rank
    its own copy over the same calls, its rows held to the parent's sim
    service by sha256; a hop fault recovered; dispatch chaos on the mesh
    tripping the breaker onto the sim."""
    import torch.distributed as dist
    from repro_torch.runtime.chaos import ChaosConfig
    from repro_torch.runtime.resilience import CircuitBreaker, RetryPolicy
    pool = _pool(seed + 1, shape["svc_pool"])
    S, T, B = shape["svc_S"], shape["svc_T"], shape["svc_batches"]
    mkw = dict(transport="mesh", mesh=mesh)

    def rows_equal(ss, what):
        for s in ss:
            check(s.state.value == "revealed" and sha(s.result) == want[s.sid],
                  f"rank {rank} (e) {what}: session {s.sid} != sim")

    svc = _mesh_service(dev, shape, **mkw)
    ss = _open_sessions(svc, pool, S * B, T)
    dist.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    ran = svc.pump()
    _sync(dev)
    secs = time.perf_counter() - t0
    check(ran == S * B, f"rank {rank} (e): {ran} sessions ran")
    rows_equal(ss, "stream")
    stream = {"seconds": secs, "seconds_per_batch": secs / B,
              "stages": _stage_means(svc)}
    del ss, svc

    retry = RetryPolicy(max_attempts=3, base_backoff_s=0.0)
    svc = _mesh_service(dev, shape, retry=retry, **mkw,
                        chaos=ChaosConfig(mode="hop", hop_k=0, times=1))
    ss = _open_sessions(svc, pool, S, T)
    svc.pump()
    rows_equal(ss, "hop fault")
    res = svc.stats["resilience"]
    check(res["chaos_injected"] == 1 and res["retries"] == 1
          and res["quarantined"] == 0, f"rank {rank} (e) hop: {res}")
    del ss, svc

    brk = CircuitBreaker(k=2, cooloff_s=1e9)
    svc = _mesh_service(dev, shape, retry=retry, breaker=brk, **mkw,
                        chaos=ChaosConfig(mode="dispatch",
                                          only_backend="mesh"))
    ss = _open_sessions(svc, pool, S, T)
    svc.pump()
    rows_equal(ss, "degraded")
    res = svc.stats["resilience"]
    check(brk.state == "open" and brk.trips == 1
          and res["degraded_batches"] == 1 and res["retries"] == 2,
          f"rank {rank} (e) breaker: {res}")
    return {"stream": stream, "hop": {"retries": 1},
            "breaker": res["breaker"],
            "degraded_batches": res["degraded_batches"]}


def phase_mesh(dev, seed: int, shape: Optional[dict] = None
               ) -> tuple[dict, dict]:
    """The distributed transports on one card: N_MESH rank processes over
    a gloo group, every wire staged through host memory, the kernels in
    every rank.  The parent computes the port's sim on the card first and
    hands the ranks its hashes."""
    from repro_torch import SecureAggregator
    from repro_torch.core.byzantine import ByzantineSpec
    from repro_torch.core.masking import quantization_error_bound
    from repro_torch.runtime.compat import spawn_nodes
    shape = dict(MESH_SHAPE if shape is None else shape, device=str(dev))
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.lib()          # the ranks load this build
    xa, xb, xd = _mesh_inputs(seed, dev, shape)
    sim = SecureAggregator(_mesh_cfg(), device=dev)
    ra = sim.allreduce(xa)
    bound = 4 * quantization_error_bound(sim.cfg.mask_cfg())
    err = float((ra.double() - xa.double().sum(0)).abs().max())
    check(err < bound, f"mesh (a) sim: err {err} >= bound {bound}")
    sim_ms = []
    for _ in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        sim.allreduce(xa)
        _sync(dev)
        sim_ms.append((time.perf_counter() - t0) * 1e3)
    rb = sim.allreduce(_tree_of(xb))
    flip_cost = SecureAggregator(_mesh_cfg(transport="digest"),
                                 device=dev).cost(shape["T"])["bytes_total"]
    over = SecureAggregator(_mesh_cfg(transport="digest", byzantine=(
        ByzantineSpec(corrupt_ranks=MESH_FLIP_OVER, mode="flip"))),
        device=dev).allreduce(xa)
    check(not torch.equal(over, ra), "mesh (c) sim: flips past the vote "
          "left the sum unchanged")
    want = {"c_over_rows": [sha(over[i]) for i in range(N_MESH)],
            "c_over_all": sha(over),
            "a_rows": [sha(ra[i]) for i in range(N_MESH)], "a_all": sha(ra),
            "a_bytes": sim.cost(shape["T"])["bytes_total"],
            "b_rows": [_tree_sha({k: v[i] for k, v in rb.items()})
                       for i in range(N_MESH)],
            "c_bytes": flip_cost, "d": sha(sim.allreduce_batched(xd))}
    # (e)'s sessions through the sim service on the card
    svc = _mesh_service(dev, shape)
    ss = _open_sessions(svc, _pool(seed + 1, shape["svc_pool"]),
                        shape["svc_S"] * shape["svc_batches"],
                        shape["svc_T"])
    svc.pump()
    want["e"] = [sha(s.result) for s in ss]
    del xa, xb, xd, ra, rb, over, ss, svc
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    job = pathlib.Path(tempfile.mkdtemp(prefix="mesh-phase-"))
    try:
        (job / "want.json").write_text(json.dumps(want))
        t0 = time.perf_counter()
        spawn_nodes(_mesh_rank, N_MESH, seed, str(job), shape)
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((job / f"rank{r}.json").read_text())
                 for r in range(N_MESH)]
    finally:
        shutil.rmtree(job, ignore_errors=True)
    for k in ("a", "b", "c", "d"):
        check(all(r[f"{k}_launches"] == ranks[0][f"{k}_launches"]
                  for r in ranks), f"mesh ({k}): launches differ by rank")

    def slowest(part):
        runs = zip(*(r[part]["wall_ms"] for r in ranks))
        return statistics.median(max(run) for run in runs)

    def split(part):
        return [{"rank": r["rank"],
                 "wall_ms": statistics.median(r[part]["wall_ms"]),
                 "wire_ms": {k: statistics.median(v)
                             for k, v in r[part]["wire_ms"].items()},
                 "profile": r[part]["profile"]} for r in ranks]

    line = {"phase": "mesh", "ranks": N_MESH, "backend": "gloo",
            "device": str(dev), "T": shape["T"],
            "chunk_elems": shape["chunk"], "batched": [shape["S"],
                                                       shape["T_batch"]],
            "equal_sim": True, "sim_err": err, "sim_bound": bound,
            "bytes_sent": want["a_bytes"],
            "launches_per_rank": {k: ranks[0][f"{k}_launches"]
                                  for k in ("a", "b", "c", "d")},
            "a_slowest_rank_ms": slowest("a"),
            "b_slowest_rank_ms": slowest("b"), "sim_a_ms": sim_ms,
            "a_split": split("a"), "b_split": split("b"),
            "peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks],
            "spawn_to_end_s": spawn_s,
            "e_service": {
                "sessions": shape["svc_S"] * shape["svc_batches"],
                "T": shape["svc_T"], "depth": 2, "equal_sim": True,
                "hop_fault_recovered": True,
                "breaker": ranks[0]["e"]["breaker"],
                "slowest_rank_s_per_batch": max(
                    r["e"]["stream"]["seconds_per_batch"] for r in ranks),
                "rank0_stage_mean_s": ranks[0]["e"]["stream"]["stages"]}}
    return line, ranks[0]["a_launches"]


def phase_paillier(dev) -> tuple[dict, dict, tuple[int, int]]:
    """Threshold Paillier and the paper's DA protocol at full width, with
    the partial decryptions on the card.  Returns the line, the DA path's
    launches and the decryption's (rows, exponent bits)."""
    from repro_torch.core import protocol
    from repro_torch.core.overlay import build_overlay
    from repro_torch.crypto import paillier
    from repro_torch.kernels import backend

    # (a) one threshold decryption of 512 summed votes
    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    tp, shares = paillier.threshold_keygen(
        bits=KEY_BITS, t=C_THRESHOLD // 2 + 1, c=C_THRESHOLD, p=P_FULL,
        q=Q_FULL)
    keygen_s = time.perf_counter() - t0
    votes = np.random.default_rng(KEY_BITS).integers(0, 2, N_OVERLAY)
    t0 = time.perf_counter()
    agg = None
    for v in votes.tolist():
        ct = tp.pk.encrypt(v)
        agg = ct if agg is None else tp.pk.add(agg, ct)
    encrypt_s = time.perf_counter() - t0
    decryptors = shares[:N_DECRYPT]
    nbits = max((2 * tp.delta * sh.value).bit_length() for sh in decryptors)
    backend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts = tp.partial_decrypt_batch(agg, decryptors, device=dev)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in backend.MODMUL}
    t0 = time.perf_counter()
    want = tp.partial_decrypt_batch(agg, decryptors, use_kernel=False)
    pow_s = time.perf_counter() - t0
    check(parts == want, "partial decryptions on the card equal pow")
    check(tp.combine(parts) == int(votes.sum()), "combine: the vote sum")
    check(launches == {"mont_mul": 1, "mont_exp": 1},
          f"a decryption's launches {launches}: want one ladder and one "
          "exit multiply")
    ladder = profile_device(
        lambda: tp.partial_decrypt_batch(agg, decryptors, device=dev))

    # (b) the DA protocol over a 512-node overlay, Step 4 on the card; the
    # key's primes are the committed ones, so its shapes are fixed
    seed = 0

    def run(kernel_crypto: bool):
        ov = build_overlay(N_OVERLAY, TAU_OVERLAY, seed=seed)
        proto = protocol.DAProtocol(ov, key_bits=KEY_BITS, seed=seed,
                                    kernel_crypto=kernel_crypto, device=dev,
                                    primes=(P_FULL, Q_FULL))
        t0 = time.perf_counter()
        res = proto.run()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    backend.reset_launch_counts()
    res, da_s = run(True)
    path_launches = backend.launch_counts()
    ref, da_pow_s = run(False)
    check(res.exact and res.output == res.expected, "DA protocol exact")
    check(res.cluster_sizes[-1] == C_THRESHOLD,
          f"threshold cluster of {res.cluster_sizes[-1]} members")
    check(path_launches["mont_exp"] > 0 and
          path_launches["mont_mul"] == path_launches["mont_exp"],
          f"DA protocol launches {path_launches}: one ladder and one exit "
          "multiply a decryption")
    for k in ("output", "expected", "exact", "phase_bytes", "n", "g",
              "cluster_sizes"):
        check(getattr(res, k) == getattr(ref, k), f"DA protocol {k}")
    check(dataclasses.asdict(res.stats) == dataclasses.asdict(ref.stats),
          "DA protocol stats")
    ct_bytes = (tp.pk.n2.bit_length() + 7) // 8
    # Step 4 counts c_t messages of 2 ciphertexts for each decryptor
    rows = res.phase_bytes["decrypt"] // (C_THRESHOLD * ct_bytes * 2)
    return ({"phase": "paillier", "key_bits": KEY_BITS,
             "n2_bits": tp.pk.n2.bit_length(), "c_t": C_THRESHOLD,
             "t": tp.t, "decryptors": len(decryptors), "nbits": nbits,
             "launches": launches, "kernel_s": kernel_s,
             "pow_s": pow_s, "keygen_s": keygen_s, "encrypt_s": encrypt_s,
             "ladder_profile": ladder,
             "plaintext": int(votes.sum()), "equal_pow": True,
             "da": {"n": res.n, "g": res.g,
                    "cluster_sizes": res.cluster_sizes,
                    "output": res.output, "exact": res.exact,
                    "messages": res.stats.messages,
                    "bytes": res.stats.bytes, "launches": path_launches,
                    "decryptors": rows,
                    "decryptions": path_launches["mont_exp"],
                    "seconds": da_s,
                    "pow_seconds": da_pow_s, "equal_pow_run": True},
             "seconds": time.perf_counter() - phase_t0},
            path_launches, (rows, nbits))


def check_widths(arch: str, cfg) -> None:
    """The port's full config against the reference's published widths."""
    want = REFERENCE_WIDTHS[arch]
    got = {k: getattr(cfg, k) for k in want if k != "ssm"}
    got["ssm"] = dataclasses.asdict(cfg.ssm) if cfg.ssm else None
    check(got == want, f"{arch} widths {got} != reference {want}")


def phase_serve(dev, seed: int,
                shape=(SERVE_BATCH, SERVE_PROMPT, SERVE_GEN), configs=None
                ) -> tuple[dict, dict]:
    """Both models served at full width through the kernels, with the
    float32 prefill held against the plain versions.  ``configs`` (arch
    -> config) replaces the full configs in a CPU rehearsal."""
    from repro_torch.configs import get_config
    batch, prompt, gen = shape
    out, launches = {"phase": "serve", "batch": batch, "prompt_len": prompt,
                     "gen": gen}, {}
    for arch in REFERENCE_WIDTHS:
        cfg = configs[arch] if configs else get_config(arch)
        if configs is None:
            check_widths(arch, cfg)
        out[arch], launches[SERVE_KERNEL[arch]] = _serve_arch(
            arch, cfg, dev, seed, shape)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out, launches


def _serve_arch(arch: str, cfg, dev, seed: int, shape) -> tuple[dict, int]:
    """One model: every tensor it makes dies when it returns."""
    from repro_torch.kernels import backend
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    batch, prompt, gen = shape
    kname = SERVE_KERNEL[arch]
    n_layers = cfg.n_layers
    cuda = dev.type == "cuda"
    tokens = _serve_prompts(cfg, batch, prompt, seed, dev)
    max_seq = prompt + gen

    def master():
        """The float32 master weights drawn from the seed on the card (the
        same numbers every call)."""
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return M.init_params(cfg, g)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # the weights as served, bf16: the float32 masters are dropped so the
    # peak is the serving footprint; a short serve first, so the timed one
    # finds cuBLAS, the kernel library and the allocator warm
    cast = M.cast_params(cfg, master())
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(cast))
    serve(cfg, batch=batch, prompt_len=64, gen=2, seed=seed, params=cast,
          device=dev)
    mem_before = 0
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats()
        mem_before = torch.cuda.memory_allocated()
    # 1. the bf16 serve through the kernels
    res = serve(cfg, batch=batch, prompt_len=prompt, gen=gen, seed=seed,
                params=cast, device=dev)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    toks = res["tokens"]
    check(toks.shape == (batch, gen) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all()),
        f"{arch}: tokens {toks.shape}")
    # 2. launches: one kernel per layer in the prefill, none in decode
    pre, dec = res["launches"]["prefill"], res["launches"]["decode"]
    check(pre[kname] == n_layers and sum(pre.values()) == n_layers,
          f"{arch}: prefill launches {pre}, want {n_layers} {kname}")
    check(sum(dec.values()) == 0, f"{arch}: decode launches {dec}")
    # the warm prefill alone, three times
    prefill_s = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        M.prefill(cfg, cast, {"tokens": tokens}, max_seq)
        sync()
        prefill_s.append(time.perf_counter() - t0)
    # 4. the bf16 serve through the plain versions, and the bf16 prefill
    # logits of both
    plain = serve(cfg, batch=batch, prompt_len=prompt, gen=gen, seed=seed,
                  params=cast, device=dev, kernel_impl="torch")
    check(sum(plain["launches"]["prefill"].values()) == 0,
          f"{arch}: the plain run launched a kernel")
    lb, _ = M.prefill(cfg, cast, {"tokens": tokens}, max_seq)
    lbp, _ = M.prefill(cfg, cast, {"tokens": tokens}, max_seq, impl="torch")
    bf16_err = max_abs_err(lb.float(), lbp.float())
    profiles = _profile_serve(cfg, cast, tokens, max_seq, prompt) \
        if cuda else {}
    del cast, lb, lbp
    # 3. the float32 prefill, kernels against plain versions, then one
    # float32 decode step, which launches nothing
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = master()
    backend.reset_launch_counts()
    lk, cache = M.prefill(cfg32, params, {"tokens": tokens}, max_seq)
    f32_launches = backend.launch_counts()[kname]
    lp, _ = M.prefill(cfg32, params, {"tokens": tokens}, max_seq,
                      impl="torch")
    check(backend.launch_counts()[kname] == f32_launches == n_layers,
          f"{arch}: float32 prefill launches {f32_launches}")
    f32_err = max_abs_err(lk, lp)
    check(bool(torch.isfinite(lk).all()) and f32_err <= LOGIT_TOL_F32,
          f"{arch}: float32 prefill logits differ by {f32_err}")
    nxt = torch.argmax(lk[:, -1, :cfg.vocab_size], -1)[:, None]
    M.decode_step(cfg32, params, cache, nxt, prompt)
    check(backend.launch_counts()[kname] == n_layers,
          f"{arch}: float32 decode launched a kernel")
    return {
        "prefill_s": res["t_prefill_s"],
        "prefill_s_warm": prefill_s,
        "prefill_s_warm_median": statistics.median(prefill_s),
        "decode_s": res["t_decode_s"], "decode_tok_per_s": res["tok_per_s"],
        "peak_mem_bytes": peak, "mem_at_reset_bytes": mem_before,
        "weight_bytes": weight_bytes, "params": cfg.param_count(),
        "launches_prefill": pre[kname],
        "launches_decode": sum(dec.values()),
        "f32_prefill_logit_max_err": f32_err,
        "f32_logit_tol": LOGIT_TOL_F32,
        "f32_logit_max_abs": float(lp.abs().max()),
        "bf16_prefill_logit_max_err_vs_plain": bf16_err,
        "bf16_tokens_equal_plain_share": float(
            (plain["tokens"] == toks).mean()),
        "plain_prefill_s": plain["t_prefill_s"],
        "plain_decode_tok_per_s": plain["tok_per_s"],
        "profiles": profiles,
        "sample_tokens": toks[0, :8].tolist()}, pre[kname]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _profile_serve(cfg, params, tokens, max_seq: int, prompt: int) -> dict:
    """One profiled prefill and 4 profiled decode steps: device time by
    kernel and the device's busy share."""
    from repro_torch.models import model as M
    holder = {}

    def prefill():
        holder["out"] = M.prefill(cfg, params, {"tokens": tokens}, max_seq)

    out = {"prefill": profile_device(prefill, ("ssd_", "flash_"))}
    logits, cache = holder.pop("out")
    nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]

    def decode():
        c = cache
        for i in range(4):
            _, c = M.decode_step(cfg, params, c, nxt, prompt + i)

    out["decode_4_steps"] = profile_device(decode)
    return out


def _serve_prompts(cfg, batch: int, prompt: int, seed: int, dev):
    """The prompts ``serve`` builds: the reference's synthetic stream."""
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    stream = SyntheticStream(DataConfig(seq_len=prompt, global_batch=batch,
                                        seed=seed), cfg)
    return torch.from_numpy(stream.global_batch(0)["tokens"]).to(dev)


def _network_exchanges(r: int) -> int:
    return sum(len(range(p % 2, r - 1, 2)) for p in range(r))


def phase_timing(rng, dev, xs, decrypt: tuple[int, int]
                 ) -> tuple[dict, dict]:
    """Kernel and plain-version times at the main paths' shapes, with the
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
    rows, nbits = decrypt
    mm = time_mont_mul(rng, dev, [(rows, 128), (1056, 128)])
    out["mont_mul"] = mm[f"{rows}x128"]
    out["mont_exp"] = time_mont_exp(rng, dev, rows, 128, nbits)
    out["flash_attention"] = time_flash(rng, dev)
    from repro_torch.kernels.ssd.ops import CHUNK
    Bsz, S, H, P, N = SERVE_BATCH, SERVE_PROMPT, 32, 64, 128
    # the chunk states, written, read and rewritten, read again
    out["ssd"] = {**time_ssd(rng, dev), "kernel_chunk": CHUNK,
                  "scratch_state_bytes": 4 * Bsz * H * (-(-S // CHUNK))
                  * P * N}
    return {"phase": "timing", "shapes": {"rows": B, "T": T, "r": r},
            "kernels": out, "mont_mul": mm,
            "allreduce": _time_allreduce(xs, dev),
            "nvidia_smi": smi_line()}, out


def device_ms(fn, reps: int, inner: int) -> float:
    """Median device time of one of ``inner`` back-to-back calls of
    ``fn``, in ms.  A spin kernel queued first holds the stream while the
    host enqueues the events and the calls, so host launch overhead stays
    outside the events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4 * host_s * 2e9) + 100_000     # clock < 2 GHz: covered
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def product_ops(L: int) -> int:
    """32-bit integer instructions of one Montgomery product on s digits
    (s = L / 2 32-bit digits, or L 16-bit ones for an odd L): s (10 s + 5)
    + 12 s -- per digit and step two low and two high products and the
    64-bit adds of the slots; m and the fold; the lookahead tail."""
    s = L // 2 if L % 2 == 0 else L
    return s * (10 * s + 5) + 12 * s


def mont_mul_work(rows: int, L: int) -> tuple[int, int]:
    """(bytes, 32-bit integer instructions) one Montgomery product of
    ``rows`` rows of L limbs needs: a, b and the output once each and n;
    one product on the kernel's digits a row."""
    return 4 * (3 * rows * L + L), rows * product_ops(L)


def time_mont_mul(rng, dev, shapes) -> dict:
    """``mont_mul`` kernel and plain times, with bounds, at (rows, L)."""
    from repro_torch.crypto.limb import montgomery_params
    from repro_torch.kernels.modmul import ops as mm
    out = {}
    for rows, L in shapes:
        n = _rand_below(rng, 1 << (16 * L - 1)) | (1 << (16 * L - 2)) | 1
        mp = montgomery_params(n, L)
        nl = torch.from_numpy(mp["n_limbs"].astype(np.int32)).to(dev)
        a = torch.randint(0, 1 << 16, (rows, L), dtype=torch.int32,
                          device=dev)
        a[:, -1] = 0                      # operands below n
        b = a.roll(1, 0).contiguous()
        kernel_ms = device_ms(
            lambda: mm.mont_mul_op(a, b, nl, mp["n0inv"]), reps=7, inner=200)
        plain_ms = cuda_ms(
            lambda: mm.mont_mul_op(a, b, nl, mp["n0inv"], impl="torch"),
            reps=3)
        nbytes, int_ops = mont_mul_work(rows, L)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = int_ops / INT32_OPS_PER_S * 1e3
        out[f"{rows}x{L}"] = {
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "int_ops": int_ops, "bytes_ms": bytes_ms,
            "operations_ms": ops_ms, "library_ms": None}
    return out


def mont_exp_work(rows: int, L: int, nbits: int) -> tuple[int, int]:
    """(bytes, 32-bit integer instructions) the ladder needs for ``rows``
    rows of L limbs and nbits exponent bits: the bases, the output, n,
    R mod n and the bits once each; per row and bit two products on s =
    L / 2 digits of s (10 s + 5) + 12 s instructions each (per digit and
    step two low and two high products and the 64-bit adds of the slots;
    m and the fold; the lookahead tail) and one select a digit."""
    return (4 * (2 * rows * L + 2 * L + rows * nbits),
            rows * nbits * (2 * product_ops(L) + L // 2))


def time_mont_exp(rng, dev, rows: int, L: int, nbits: int) -> dict:
    """The one-launch ladder at the decryption's shape, beside the host
    loop of two ``mont_mul`` launches a bit that it replaced (in turns:
    ladder, loop, loop, ladder) and its plain version, timed once and
    held equal to it."""
    from repro_torch.kernels.modmul import ops as mm
    n = _rand_below(rng, 1 << (16 * L - 1)) | (1 << (16 * L - 2)) | 1
    xs = [_rand_below(rng, n) for _ in range(rows)]
    exps = [_rand_below(rng, 1 << nbits) | 1 << (nbits - 1)
            for _ in range(rows)]
    mp, a, bits, one = _ladder_inputs(n, L, xs, exps, dev)
    nl = torch.from_numpy(mp["n_limbs"].astype(np.int32)).to(dev)

    def ladder():
        return mm.mont_exp_op(a, bits, mp["n_limbs"], mp["n0inv"], one)

    def loop():
        return mm.mont_exp_loop(a, bits, nl, mp["n0inv"], one)

    ladder_ms, loop_ms = [cuda_ms(ladder, reps=3)], [cuda_ms(loop, reps=1)]
    loop_ms.append(cuda_ms(loop, reps=1))
    ladder_ms.append(cuda_ms(ladder, reps=3))
    got = ladder()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = mm.mont_exp_op(a, bits, mp["n_limbs"], mp["n0inv"], one,
                          impl="torch")
    end.record()
    end.synchronize()
    check(torch.equal(got, want), "mont_exp at the decryption's shape "
          "equals the plain ladder")
    nbytes, int_ops = mont_exp_work(rows, L, nbits)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = int_ops / INT32_OPS_PER_S * 1e3
    ms = statistics.median(ladder_ms)
    return {"ms": ms, "ladder_ms": ladder_ms, "loop_ms": loop_ms,
            "plain_ms": start.elapsed_time(end), "rows": rows, "L": L,
            "nbits": nbits, "us_per_product": ms * 1e3 / (2 * nbits),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "int_ops": int_ops, "bytes_ms": bytes_ms,
            "operations_ms": ops_ms, "library_ms": None}


def bound(nbytes: float, flops: float, flops_per_s: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "operations_ms": ops_ms}


def time_flash(rng, dev) -> dict:
    """``flash_attention`` at qwen3-1.7b's prefill (B 4, S 2048, H 16,
    K 8, hd 128, causal, bf16), its plain version, and
    ``scaled_dot_product_attention`` on the same inputs in its (B, H, S,
    hd) layout (timed here only; the port never calls it)."""
    from repro_torch.kernels.flash_attention import flash_attention
    B, S, H, K, hd = SERVE_BATCH, SERVE_PROMPT, 16, 8, 128
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, n, hd),
                                                    np.float32)
                                ).to(dev, torch.bfloat16)
               for n in (H, K, K))
    kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True),
                        reps=10)
    plain_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True,
                                               impl="torch"), reps=3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True), reps=10)
    got = flash_attention(q, k, v, causal=True).transpose(1, 2).float()
    lib_err = max_abs_err(got, sdpa(qt, kt, vt, is_causal=True,
                                    enable_gqa=True).float())
    # the causal pairs (i >= j) of two products, 2 FLOP a multiply-add
    flops = 4 * B * H * hd * S * (S + 1) // 2
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * K * hd)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True)",
            "library_max_abs_err": lib_err,
            "shape": [B, S, H, K, hd], **bound(nbytes, flops,
                                                BF16_FLOPS_PER_S)}


def ssd_flops_at(Bsz: int, S: int, H: int, P: int, N: int, Q: int) -> int:
    """FLOPs of the split scan in chunks of Q (S padded to a multiple):
    the lower triangle of C B^T once per batch row and chunk, shared by
    its H heads; per head the lower triangle of (L o C B^T)(x dt), the
    state's two products, C state^T and (x dt)^T B, and the state
    passing's multiply-add per state element and chunk boundary."""
    nc = -(-S // Q)
    Sp = nc * Q
    tri = Sp * (Q + 1) // 2
    return 2 * (Bsz * tri * N
                + Bsz * H * (tri * P + 2 * Sp * N * P + (nc - 1) * P * N))


def ssd_flops(Bsz: int, S: int, H: int, P: int, N: int) -> tuple[int, int]:
    """The least FLOPs the scan needs at these shapes, over every chunk
    length Q (the work depends on Q, the result does not), and that Q."""
    return min((ssd_flops_at(Bsz, S, H, P, N, Q), Q) for Q in range(1, S + 1))


def time_ssd(rng, dev) -> dict:
    """``ssd_chunked`` at mamba2-370m's prefill (B 4, S 2048, 32 heads of
    P = 64, N = 128, B and C shared by the heads) and its plain version.
    ``ms`` is the CUDA-event median of single calls, the host's enqueueing
    of the wrapper's launches and scratch included; ``queued_ms`` the
    device time of one of 20 calls queued back to back; ``by_kernel_ms``
    each kernel's mean device time a launch, and its launches seen, in a
    profiled run of 200 calls (late in a long process the profiler can
    drop a window's first launches, so means, not sums), and
    ``kernels_ms`` their sum, one call's device time.  The bound is the
    least work over every chunking at the rate of the unit the kernel
    runs on (3xTF32 on the tensor cores), with the float32 CUDA-core
    rate's beside it."""
    from repro_torch.kernels.ssd import ssd_chunked
    Bsz, S, H, P, N = SERVE_BATCH, SERVE_PROMPT, 32, 64, 128
    args = _ssd_inputs(rng, dev, Bsz, S, H, P, N=N, per_head=False)

    def call():
        return ssd_chunked(*args, 256)

    kernel_ms = cuda_ms(call, reps=10)
    queued_ms = device_ms(call, reps=5, inner=20)
    def calls():
        for _ in range(200):
            call()

    prof = profile_device(calls)
    by_kernel = [(name, ms / n, n) for name, ms, n in prof["by_kernel_ms"]]
    plain_ms = cuda_ms(lambda: ssd_chunked(*args, 256, impl="torch"), reps=3)
    # x and y, dt, A, B and C once each, the final state written once
    nbytes = 4 * (2 * Bsz * S * H * P + Bsz * S * H + H + 2 * Bsz * S * N
                  + Bsz * H * P * N)
    flops, least_q = ssd_flops(Bsz, S, H, P, N)
    f32 = bound(nbytes, flops, F32_FLOPS_PER_S)
    return {"ms": kernel_ms, "queued_ms": queued_ms,
            "by_kernel_ms": by_kernel,
            "kernels_ms": sum(ms for _, ms, _ in by_kernel),
            "plain_ms": plain_ms, "library_ms": None,
            "shape": [Bsz, S, H, P, N], "unit": "tensor cores, 3xTF32",
            "bound_chunk": least_q,
            **bound(nbytes, flops, F32_3XTF32_FLOPS_PER_S),
            "bound_f32_ms": f32["bound_ms"], "bound_f32_by": f32["bound_by"]}


def _time_allreduce(xs, dev) -> dict:
    """Host-clock median of the full-width allreduce, and one profiled
    call: device time by kernel name and the device's busy share."""
    from repro_torch import SecureAggregator
    agg = SecureAggregator(**_main_cfg(), device=dev)
    agg.allreduce(xs)
    host = [_run(agg, xs)[2] for _ in range(3)]
    return {"host_s": host, "median_s": statistics.median(host),
            **profile_device(lambda: agg.allreduce(xs))}


def profile_device(fn, parts: tuple = ()) -> dict:
    """One profiled call of ``fn``: its wall time, device time by kernel
    name, the device's busy share, and for each of ``parts`` the device
    time and launches of the kernels whose names contain it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # operators repeat their kernels' device time; gloo's transfers
        # are host work that the profiler files under the device
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("gloo:"):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((ev.key[:80], dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"profiled_wall_s": wall, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3),
            "by_kernel_ms": rows[:12],
            "by_part": {p: {"ms": sum(r[1] for r in rows if p in r[0]),
                            "launches": sum(r[2] for r in rows if p in r[0])}
                        for p in parts}}


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
    # float32 products in full float32 (also the default), stated for the
    # float checks; no convolution runs, so cuDNN's TF32 switch is moot
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import backend
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    if "build" in phases:
        emit(phase_build())
    errs = {k.name: 0.0 for k in backend.KERNELS}
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
        line, main_launches = phase_main(xs, ref, dev)
        launches.update(main_launches)
        del ref
        emit(line)
    if "batched" in phases:
        emit(phase_batched(rng, dev))
    service_launches = None
    if "service" in phases:
        line, service_launches = phase_service(dev, args.seed)
        emit(line)
    mesh_launches = None
    if "mesh" in phases:
        line, mesh_launches = phase_mesh(dev, args.seed)
        emit(line)
    decrypt = (N_DECRYPT, DECRYPT_BITS)
    if "paillier" in phases:
        line, da_launches, decrypt = phase_paillier(dev)
        for k in backend.MODMUL:
            launches[k.name] = da_launches[k.name]
        emit(line)
    if "serve" in phases:
        line, serve_launches = phase_serve(dev, args.seed)
        launches.update(serve_launches)
        emit(line)
    if "timing" in phases:
        line, timing = phase_timing(rng, dev, xs, decrypt)
        emit(line)

    kernels = []
    for k in backend.KERNELS:
        t = timing.get(k.name, {})
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches.get(k.name),
            "max_abs_err": errs[k.name] if "kernels" in phases else None,
            "ms": t.get("ms"),
            "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
            "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
            "mesh_launches_per_rank": (None if mesh_launches is None
                                       else mesh_launches[k.name]),
            "service_launches": (None if service_launches is None
                                 else service_launches[k.name])})
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
