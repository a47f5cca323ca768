"""Ring helpers of the secure-aggregation kernels, as plain torch.

Counterpart of ``repro/kernels/secure_agg/secure_agg.py`` (its constants,
``splitmix32``, ``pad_stream``, ``pairwise_total``, ``as_copy_list`` and
``median_network``).  The hand-written CUDA kernels that replace the
Pallas ones live in ``csrc/secure_agg.cu``; these functions are the
arithmetic the plain versions (``ref.py``) are built from.

Ring values Z_{2^32} are stored on the device as ``torch.int32`` holding
the uint32 bit pattern.  torch's ``uint32`` lacks ``+``, ``-``, ``>>``
and comparisons, and ``int32 >>`` is arithmetic, so the plain path
*widens*: :func:`wide` maps int32 words to int64 values in [0, 2^32),
every helper here computes on those, masks with ``M32`` and
:func:`narrow` returns int32 words.  Multiplications by the 32-bit
mixing constants are split into 16-bit halves (:func:`mul32`) so no
int64 product ever overflows.  Every helper also accepts Python ints,
which is how per-row keys are derived on the host.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

GOLDEN = 0x9E3779B9
MIX1 = 0x85EBCA6B
MIX2 = 0xC2B2AE35
M32 = 0xFFFFFFFF

# keys for pairwise pads live in a disjoint space from per-node keys
PAIRWISE_KEY_BASE = 1 << 20


def wide(x: torch.Tensor) -> torch.Tensor:
    """int32 words (uint32 bit patterns) -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & M32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 values (any, taken mod 2^32) -> int32 words."""
    x = x & M32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def s32(v: int) -> int:
    """A uint32 Python int as the int32 value with the same bits."""
    v &= M32
    return v - (1 << 32) if v >= 1 << 31 else v


def mul32(a, b: int):
    """``a * b mod 2^32`` for wide ``a`` and a constant ``b < 2^32``,
    exact in int64: the high half of ``b`` only reaches the low 16 bits
    of its partial product."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def splitmix32(x):
    """Counter-based PRF core (uint32 -> uint32) on wide values."""
    x = (x + GOLDEN) & M32
    x = mul32(x ^ (x >> 16), MIX1)
    x = mul32(x ^ (x >> 13), MIX2)
    return x ^ (x >> 16)


def pad_keys(seed, key_id):
    """The two subkeys of the stream (seed, key_id).  ``*`` binds
    tighter than ``^``: ``seed ^ (key_id * MIX1)``."""
    k1 = splitmix32(seed ^ mul32(key_id, MIX1))
    k2 = splitmix32(k1 ^ MIX2)
    return k1, k2


def pad_stream(seed, key_id, ctr):
    """The masking one-time pad PRF(seed, key_id) at counters ``ctr``
    (all wide); bit-identical to the reference's ``pad_stream``."""
    k1, k2 = pad_keys(seed, key_id)
    return (splitmix32(ctr ^ k1) + k2) & M32


def pairwise_total(seed, node_id, ctr, cluster_size: int):
    """SecAgg-style pairwise-cancelling pad of ``node_id`` within its
    cluster at counters ``ctr`` (wide tensors; ``seed``/``node_id``
    broadcast against ``ctr``):

        mask_i = sum_{j in cluster, j>i} PRF(ij) - sum_{j<i} PRF(ij)
    """
    c = cluster_size
    cluster = node_id // c
    member = node_id % c
    acc = torch.zeros_like(ctr)
    for other in range(c):
        lo = member.clamp(max=other)
        hi = member.clamp(min=other)
        pair_id = cluster * c * c + lo * c + hi + PAIRWISE_KEY_BASE
        p = pad_stream(seed, pair_id, ctr)
        contrib = torch.where(member < other, p, (-p) & M32)
        contrib = torch.where(member == other, torch.zeros_like(p), contrib)
        acc = (acc + contrib) & M32
    return acc


def as_copy_list(copies: Union[torch.Tensor, Sequence[torch.Tensor]]
                 ) -> list[torch.Tensor]:
    """Vote input: a stacked (r, T) tensor or a sequence of r tensors ->
    list of r rows."""
    if isinstance(copies, torch.Tensor):
        return [copies[i] for i in range(copies.shape[0])]
    return list(copies)


def median_network(rows: list[torch.Tensor]) -> torch.Tensor:
    """Odd-even transposition sort over a tiny list; returns the median.
    Rows must be wide, so min/max run in *unsigned* order."""
    rows = list(rows)
    r = len(rows)
    for phase in range(r):
        for i in range(phase % 2, r - 1, 2):
            lo = torch.minimum(rows[i], rows[i + 1])
            hi = torch.maximum(rows[i], rows[i + 1])
            rows[i], rows[i + 1] = lo, hi
    return rows[r // 2]
