"""What the bfloat16 decode's gates stand on, measured on the CPU: how
often the JAX package's float32 and bfloat16 arithmetic (XLA's) gives the
bits torch's gives for one operation, and how the decode's r spreads over
seeded draws.  r is ``tests/test_torch_bf16_decode.py``'s: rms(port -
ref_bf16) / rms(ref_bf16 - ref_f32).  Run from the repository's root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_bf16_rounding.py

One JSON line a measurement (~1 min on 8 cores).
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from repro.models import layers as JL
from repro_torch.models import layers as L

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_seq_cache import _Cut  # noqa: E402

N = 1 << 16


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


def _equal(a, b) -> float:
    return float(np.mean(_np(a) == _np(b)))


def _r(got, want, want32) -> float:
    got, want, want32 = _np(got), _np(want), _np(want32)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean((want - want32) ** 2)))


def elementwise() -> dict:
    """The share of N(0, 1) draws (``exp`` of -4|x|, the others of x)
    on which one operation gives the same bits in both packages."""
    x = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    e = (-4 * np.abs(x)).astype(np.float32)
    xb_j, xb_t = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return {
        "exp_f32": _equal(jnp.exp(jnp.asarray(e)),
                          torch.exp(torch.from_numpy(e))),
        "tanh_f32": _equal(jnp.tanh(jnp.asarray(x)),
                           torch.tanh(torch.from_numpy(x))),
        "cos_f32_of_300x": _equal(jnp.cos(jnp.asarray(300 * x)),
                                  torch.cos(torch.from_numpy(300 * x))),
        "silu_bf16": _equal(jax.nn.silu(xb_j), F.silu(xb_t)),
        "gelu_tanh_bf16": _equal(jax.nn.gelu(xb_j),
                                 F.gelu(xb_t, approximate="tanh")),
        "softplus_bf16": _equal(jax.nn.softplus(xb_j), F.softplus(xb_t)),
    }


def sums_and_rope() -> dict:
    """Row sums of 64 rows of 2,048 float32 exponentials, and rope of
    bfloat16 q (64 x 8 heads x 128) at position 300."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 2048)).astype(np.float32)
    q = rng.standard_normal((64, 1, 8, 128)).astype(np.float32)
    pos = 300
    return {
        "row_sum_f32": _equal(jnp.sum(jnp.exp(jnp.asarray(x)), -1),
                              torch.exp(torch.from_numpy(x)).sum(-1)),
        "rope_bf16_at_300": _equal(
            JL.rope(jnp.asarray(q, jnp.bfloat16), jnp.asarray([pos]), 1e6),
            L.rope(torch.from_numpy(q).bfloat16(), torch.tensor([pos]),
                   1e6)),
    }


def flash_blocking() -> dict:
    """The bf16 prefill attention (B 2, S 512, 8 / 4 heads, hd 64,
    causal): the port's plain version against the reference's jnp flash,
    whose online softmax runs in blocks."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 512, 8, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 512, 4, 64)).astype(np.float32)
            for _ in range(2))
    want, want32 = (JL.flash_attention(*(jnp.asarray(a, dt)
                                         for a in (q, k, v)), causal=True)
                    for dt in (jnp.bfloat16, jnp.float32))
    got = L.flash_attention(*(torch.from_numpy(a).bfloat16()
                              for a in (q, k, v)), causal=True)
    return {"flash_prefill_bf16_hd64_r": _r(got, want, want32),
            "flash_prefill_bf16_hd64_equal": _equal(got, want)}


def decode_spread(rows: int, seeds: int) -> dict:
    """r of the one-rank decode and of a cut in 4 blocks over ``seeds``
    draws each of 3 shapes at hd 64, 80 and 128 (G 8, S 1,024, t 700,
    soft-cap 30; G 5, S 2,048, t 1,500; G 1, S 512, t 300), ``rows``
    batch rows a draw: the median and the largest."""
    out = {"one": [], "cut4": []}
    gather = L.cut_gather
    try:
        _spread(rows, seeds, out)
    finally:
        L.cut_gather = gather
    return {f"{k}_rows{rows}": {"draws": len(v), "median": float(np.median(v)),
                                "max": float(np.max(v))}
            for k, v in out.items()}


def _spread(rows: int, seeds: int, out: dict) -> None:
    for seed in range(seeds):
        for hd in (64, 80, 128):
            for G, S, t, cap in ((8, 1024, 700, 30.0), (5, 2048, 1500, 0.0),
                                 (1, 512, 300, 30.0)):
                rng = np.random.default_rng(seed * 1000 + hd * 7 + G)
                q = rng.standard_normal((rows, 1, 2 * G, hd))
                k, v = (rng.standard_normal((rows, S, 2, hd))
                        for _ in range(2))
                q, k, v = (a.astype(np.float32) for a in (q, k, v))
                want, want32 = (JL.decode_attention(
                    *(jnp.asarray(a, dt) for a in (q, k, v)), jnp.int32(t),
                    softcap=cap) for dt in (jnp.bfloat16, jnp.float32))
                qt, kt, vt = (torch.from_numpy(a).bfloat16()
                              for a in (q, k, v))
                out["one"].append(_r(L.decode_attention(
                    qt, kt, vt, t, softcap=cap), want, want32))
                cut = _Cut(4)
                L.cut_gather = lambda ctx, x, kind="": cut.gather(x)
                Sb = S // 4
                got = cut.run(lambda j: L.decode_attention_cut(
                    qt, kt[:, j * Sb:(j + 1) * Sb], vt[:, j * Sb:(j + 1) * Sb],
                    t, lo=j * Sb, softcap=cap))[0]
                out["cut4"].append(_r(got, want, want32))


def main() -> None:
    torch.set_num_threads(1)
    print(json.dumps({"equal_share": elementwise()}))
    print(json.dumps({"equal_share": sums_and_rope()}))
    print(json.dumps(flash_blocking()))
    for rows in (2, 16):
        print(json.dumps({"decode_r": decode_spread(rows, 6)}), flush=True)


if __name__ == "__main__":
    main()
