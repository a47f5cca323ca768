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
describing every kernel, and ``{"ok": true, "device": {...}}``.  Without
a CUDA device the script fails before printing any result.  Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

PHASES = ("device", "build", "kernels", "main", "batched", "paillier",
          "serve", "timing")
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
        if ev.device_type != DeviceType.CUDA:   # operators repeat their
            continue                           # kernels' device time
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
            "replaces": k.replaces, "launches": launches.get(k.name, 0),
            "max_abs_err": errs[k.name], "ms": t.get("ms"),
            "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
            "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms")})
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
