"""Batched Montgomery multiplication: the plain torch version.

Counterpart of ``_mont_mul_block`` in ``repro/kernels/modmul/modmul.py``,
the body of the Pallas TPU kernel ``mont_mul``, which the CUDA kernel
``mm_mont_mul`` (``csrc/modmul.cu``) replaces on the card.  The paper's
own profile (Fig 3d) shows threshold decryption -- modular
exponentiation over n^2 -- dominating compute, and this product is its
inner step.

Lazy-carry CIOS over L 16-bit limbs, R = 2^(16 L), for each outer step i:

    T += a_i * b        (split into lo/hi 16-bit halves; no carry chain)
    m  = (T_0 & 0xffff) * n0inv & 0xffff
    T += m * n          (lo/hi split again)
    T  = shift right one limb, folding T_0's excess into the new T_0

then one serial carry pass over the L + 2 slots and the conditional
subtract, with the reference's rule ``ge_n = (borrow == 0) | (T[L] > 0)``.
Limbs are ``torch.int32`` tensors of shape (batch, L) holding values
below 2^16.  The function works in int64: no product or slot reaches
2^32 (slots stay below 2^19 L), so int64 is exact without masking, and
every slot equals the reference's uint32 slot.  The batch is the leading
dimension.
"""
from __future__ import annotations

import torch

LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1


def mont_mul_block(a: torch.Tensor, b: torch.Tensor, n_limbs, n0inv
                   ) -> torch.Tensor:
    """a, b: (batch, L) int32 limbs of Montgomery-domain operands below n;
    n_limbs: the L limbs of the odd modulus n; n0inv: -n^-1 mod 2^16.
    Returns a * b * R^-1 mod n as (batch, L) int32 limbs."""
    bb, L = a.shape
    dev = a.device
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    nl = torch.as_tensor(n_limbs).reshape(1, L).to(dev, torch.int64)
    n0inv = int(n0inv)
    # T lives in a sliding window of L + 2 slots: after step i it is
    # buf[:, i+1 : i+L+3], so the one-limb shift moves no data.  The slot
    # that enters the window at step i is buf[:, i+L+2], still zero.
    buf = torch.zeros((bb, 2 * L + 2), dtype=torch.int64, device=dev)
    for i in range(L):
        p = a[:, i:i + 1] * b
        buf[:, i:i + L] += p & MASK
        buf[:, i + 1:i + L + 1] += p >> LIMB_BITS
        m = ((buf[:, i:i + 1] & MASK) * n0inv) & MASK
        q = m * nl
        buf[:, i:i + L] += q & MASK
        buf[:, i + 1:i + L + 1] += q >> LIMB_BITS
        # shift one limb right; fold T0's high bits into the next slot
        buf[:, i + 1:i + 2] += buf[:, i:i + 1] >> LIMB_BITS
    T = buf[:, L:]

    # final carry propagation (serial over L + 2 slots)
    carry = torch.zeros((bb,), dtype=torch.int64, device=dev)
    for j in range(L + 2):
        v = T[:, j] + carry
        T[:, j] = v & MASK
        carry = v >> LIMB_BITS
    res = T[:, :L]
    over = T[:, L]  # 0 or 1 after propagation (result < 2n)

    # conditional subtract n when res >= n (or the overflow limb is set)
    d = torch.empty((bb, L), dtype=torch.int64, device=dev)
    borrow = torch.zeros((bb,), dtype=torch.int64, device=dev)
    for j in range(L):
        v = res[:, j] - nl[0, j] - borrow
        d[:, j] = v & MASK
        borrow = (v < 0).to(torch.int64)
    ge_n = (borrow == 0) | (over > 0)
    return torch.where(ge_n[:, None], d, res).to(torch.int32)
