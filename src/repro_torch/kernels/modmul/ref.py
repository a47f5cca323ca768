"""Oracles for the Montgomery-multiply kernel.

``mont_mul_ref`` -- the same lazy-carry CIOS in plain torch.
``mont_mul_int`` -- ground truth with Python big ints.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto.limb import (LIMB_BITS, batch_from_limbs,
                                     batch_to_limbs)
from repro_torch.kernels.modmul.modmul import mont_mul_block


def mont_mul_ref(a, b, n_limbs, n0inv) -> torch.Tensor:
    """(batch, L) limbs (tensors or arrays) -> (batch, L) int32 limbs."""
    return mont_mul_block(torch.as_tensor(a).to(torch.int32),
                          torch.as_tensor(b).to(torch.int32), n_limbs, n0inv)


def mont_mul_int(a_limbs: np.ndarray, b_limbs: np.ndarray, n: int,
                 L: int) -> np.ndarray:
    """Ground truth: a*b*R^-1 mod n via Python ints (uint32 limbs)."""
    R_inv = pow(1 << (LIMB_BITS * L), -1, n)
    avals = batch_from_limbs(np.asarray(a_limbs))
    bvals = batch_from_limbs(np.asarray(b_limbs))
    out = [(x * y * R_inv) % n for x, y in zip(avals, bvals)]
    return batch_to_limbs(out, L)
