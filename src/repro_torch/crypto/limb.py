"""Limb representation helpers for the batched bignum kernel.

The port's own copy of ``repro/crypto/limb.py`` (numpy only).  Big
integers are stored as L little-endian 16-bit limbs, each held in a
uint32 container, so limb products and lazy carry accumulation fit in
32-bit lanes.  Montgomery arithmetic uses R = 2^(16*L).  At the torch
boundary the limbs travel as ``torch.int32`` (torch has no uint32
arithmetic); every limb is below 2^16, so the two views hold the same
values.
"""
from __future__ import annotations

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def to_limbs(x: int, L: int) -> np.ndarray:
    if x < 0 or x >> (LIMB_BITS * L):
        raise ValueError(f"value does not fit in {L} limbs")
    out = np.zeros((L,), np.uint32)
    for i in range(L):
        out[i] = (x >> (LIMB_BITS * i)) & LIMB_MASK
    return out


def from_limbs(a: np.ndarray) -> int:
    x = 0
    for i, v in enumerate(np.asarray(a, dtype=np.uint64).tolist()):
        x |= int(v) << (LIMB_BITS * i)
    return x


def batch_to_limbs(xs: list[int], L: int) -> np.ndarray:
    return np.stack([to_limbs(x, L) for x in xs])


def batch_from_limbs(arr: np.ndarray) -> list[int]:
    return [from_limbs(row) for row in arr]


def montgomery_params(n: int, L: int) -> dict:
    """Precomputed constants for CIOS Montgomery multiplication."""
    R = 1 << (LIMB_BITS * L)
    if n % 2 != 1 or n >= R:
        raise ValueError("the modulus must be odd and below R = 2^(16 L)")
    return {
        "n": n,
        "L": L,
        "R": R,
        "n_limbs": to_limbs(n, L),
        "n0inv": np.uint32(n0inv_digit(n, LIMB_BITS)),
        "R2": R * R % n,          # to enter the Montgomery domain
    }


def n0inv_digit(n: int, bits: int) -> int:
    """-n^-1 mod 2^bits for an odd n: CIOS's per-digit constant (16 for
    the limbs, 32 for the ladder kernel's digits)."""
    return (-pow(n, -1, 1 << bits)) % (1 << bits)


def to_mont(x: int, mp: dict) -> int:
    return x * mp["R"] % mp["n"]


def from_mont(x: int, mp: dict) -> int:
    return x * pow(mp["R"], -1, mp["n"]) % mp["n"]


def limbs_needed(n: int) -> int:
    L = (n.bit_length() + LIMB_BITS - 1) // LIMB_BITS
    # a multiple of 8, as in the reference, so both packages agree on L
    return -(-L // 8) * 8
