"""Dispatch layer for the Montgomery multiply and the batched modular
exponentiation over it -- the threshold-decryption hot loop.

Counterpart of ``repro/kernels/modmul/ops.py``.  ``mont_mul_op`` picks,
through :func:`repro_torch.kernels.backend.resolve`, the CUDA kernel
``mm_mont_mul`` for a CUDA tensor and the plain version
(``modmul.mont_mul_block``) for a CPU tensor or an explicit
``impl="torch"``.  ``mont_exp_op`` is the square-and-multiply ladder:
on a CUDA tensor one launch of ``mm_mont_exp`` runs every bit; the plain
version (a CPU tensor or ``impl="torch"``) is ``mont_exp_loop``, the
reference's loop of two products a bit, which also runs on the card
over ``mm_mont_mul`` when called with ``impl=None``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.crypto.limb import (batch_to_limbs, from_limbs,
                                     montgomery_params, n0inv_digit,
                                     to_limbs, to_mont)
from repro_torch.kernels import backend, build
from repro_torch.kernels.backend import MONT_EXP, MONT_MUL
from repro_torch.kernels.modmul.modmul import mont_mul_block
from repro_torch.roofline import counts

# the launcher's own argument checks (csrc/modmul.cu), by status
_REFUSED = {1001: "L limbs outside the kernel's range (even L <= 1022, "
                  "odd L <= 1021)",
            1002: "n0inv is not a 16-bit limb",
            1003: "batch does not fit a grid"}
_EXP_REFUSED = {1001: "L limbs outside the ladder's range (even L <= "
                      "1022, odd L <= 511)",
                1002: "n0inv is not a 16-bit limb (an odd L runs on "
                      "16-bit digits)",
                1003: "batch does not fit a grid",
                1004: "nbits is negative"}


def _mont_mul_cuda(a: torch.Tensor, b: torch.Tensor, n_limbs,
                   n0inv) -> torch.Tensor:
    backend.check_tensor(a, torch.int32, 2, "a")
    backend.check_tensor(b, torch.int32, 2, "b")
    batch, L = a.shape
    if b.shape != a.shape or b.device != a.device:
        raise ValueError(f"b {tuple(b.shape)} must match a {tuple(a.shape)} "
                         "on one device")
    dev = a.device
    nl = torch.as_tensor(n_limbs).to(dev, torch.int32).reshape(-1)
    if nl.numel() != L:
        raise ValueError(f"n_limbs has {nl.numel()} limbs, a has {L}")
    nl = nl.contiguous()
    n0inv = int(n0inv)
    if not 0 <= n0inv < 1 << 32:      # ctypes would wrap it silently
        raise ValueError(f"n0inv = {n0inv} does not fit a uint32")
    out = torch.empty((batch, L), dtype=torch.int32, device=dev)
    if batch == 0:
        return out
    with torch.cuda.device(dev):
        rc = build.lib().mm_mont_mul(
            a.data_ptr(), b.data_ptr(), nl.data_ptr(), n0inv,
            out.data_ptr(), batch, L, backend.stream(dev))
    backend.raise_on(rc, MONT_MUL.name, _REFUSED)
    MONT_MUL.launches += 1
    return out


def mont_mul_op(a: torch.Tensor, b: torch.Tensor, n_limbs, n0inv, *,
                impl: Optional[str] = None) -> torch.Tensor:
    """a * b * R^-1 mod n over (batch, L) int32 limbs of operands below
    n; n0inv is the limbs' -n^-1 mod 2^16, as the plain version takes
    it."""
    route = backend.resolve(impl, a)
    if route == "meta":
        nbytes, int_ops = counts.mont_mul_work(*a.shape)
        backend.record_meta(MONT_MUL, nbytes, int_ops=int_ops)
        return torch.empty(a.shape, dtype=torch.int32, device=a.device)
    if route == "cuda":
        return _mont_mul_cuda(a, b, n_limbs, n0inv)
    return mont_mul_block(a, b, n_limbs, n0inv)


def ladder_n0inv(n_limbs, n0inv, L: int) -> int:
    """The ladder kernel's n0inv: for an even L it runs on 32-bit digits
    and takes -n^-1 mod 2^32, from n's two low limbs as Python ints; for
    an odd L, 16-bit digits and the limbs' own n0inv.  (``mm_mont_mul``
    takes the limbs' n0inv and lifts it to 32 bits itself.)"""
    if L % 2:
        return int(n0inv)
    if isinstance(n_limbs, torch.Tensor):
        low = n_limbs.reshape(-1)[:2].cpu().tolist()
    else:
        low = np.asarray(n_limbs).reshape(-1)[:2].tolist()
    return n0inv_digit(int(low[0]) | int(low[1]) << 16, 32)


def _mont_exp_cuda(a: torch.Tensor, e_bits: torch.Tensor, n_limbs, n0inv,
                   one_mont: torch.Tensor) -> torch.Tensor:
    backend.check_tensor(a, torch.int32, 2, "a")
    backend.check_tensor(e_bits, torch.int32, 2, "e_bits")
    batch, L = a.shape
    nbits = e_bits.shape[1]
    if e_bits.shape[0] != batch or e_bits.device != a.device:
        raise ValueError(f"e_bits {tuple(e_bits.shape)} must have a's "
                         f"{batch} rows on its device")
    dev = a.device
    nl = torch.as_tensor(n_limbs).to(dev, torch.int32).reshape(-1)
    one = torch.as_tensor(one_mont).to(dev, torch.int32).reshape(-1)
    if nl.numel() != L or one.numel() != L:
        raise ValueError(f"n_limbs and one_mont need {L} limbs, got "
                         f"{nl.numel()} and {one.numel()}")
    nl, one = nl.contiguous(), one.contiguous()
    n0 = ladder_n0inv(n_limbs, n0inv, L)
    out = torch.empty((batch, L), dtype=torch.int32, device=dev)
    if batch == 0:
        return out
    with torch.cuda.device(dev):
        rc = build.lib().mm_mont_exp(
            a.data_ptr(), e_bits.data_ptr(), nl.data_ptr(), n0,
            one.data_ptr(), out.data_ptr(), batch, L, nbits,
            backend.stream(dev))
    backend.raise_on(rc, MONT_EXP.name, _EXP_REFUSED)
    MONT_EXP.launches += 1
    return out


def mont_exp_op(a: torch.Tensor, e_bits: torch.Tensor, n_limbs, n0inv,
                one_mont: torch.Tensor, *,
                impl: Optional[str] = None) -> torch.Tensor:
    """Batched left-to-right square-and-multiply.

    a: (batch, L) int32 Montgomery-domain bases below n; e_bits: (batch,
    nbits) int32 exponent bits, MSB first; one_mont: (L,) limbs of R mod
    n.  A CUDA tensor runs the whole ladder in one kernel launch."""
    route = backend.resolve(impl, a)
    if route == "meta":
        nbytes, int_ops = counts.mont_exp_work(*a.shape, e_bits.shape[1])
        backend.record_meta(MONT_EXP, nbytes, int_ops=int_ops)
        return torch.empty(a.shape, dtype=torch.int32, device=a.device)
    if route == "cuda":
        return _mont_exp_cuda(a, e_bits, n_limbs, n0inv, one_mont)
    return mont_exp_loop(a, e_bits, n_limbs, n0inv, one_mont, impl="torch")


def mont_exp_loop(a: torch.Tensor, e_bits: torch.Tensor, n_limbs, n0inv,
                  one_mont: torch.Tensor, *,
                  impl: Optional[str] = None) -> torch.Tensor:
    """The ladder as a host loop over ``mont_mul_op``, two products and a
    select a bit: the plain version of ``mont_exp_op`` (``impl="torch"``),
    and with ``impl=None`` on the card the per-product kernel loop the
    one-launch ladder replaced."""
    batch, L = a.shape
    nbits = e_bits.shape[1]
    nl = torch.as_tensor(n_limbs).to(a.device, torch.int32)
    acc = one_mont.reshape(1, L).to(a.device, torch.int32).expand(
        batch, L).contiguous()
    for i in range(nbits):
        acc = mont_mul_op(acc, acc, nl, n0inv, impl=impl)
        mul = mont_mul_op(acc, a, nl, n0inv, impl=impl)
        acc = torch.where(e_bits[:, i:i + 1] > 0, mul, acc)
    return acc


def _limbs(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rows.astype(np.int32)).to(device)


def exponent_bits(exps: Sequence[int], nbits: int) -> np.ndarray:
    """(len(exps), nbits) 0/1 exponent bits, MSB first."""
    text = "".join(format(e, f"0{nbits}b") for e in exps)
    bits = np.frombuffer(text.encode(), np.uint8) - ord("0")
    return bits.reshape(len(exps), nbits).astype(np.int32)


def modexp_ints(bases: list[int], exps: list[int], n: int, L: int, *,
                device=None, impl: Optional[str] = None) -> list[int]:
    """Batched b^e mod n over Python ints: on the card one ``mm_mont_exp``
    launch for the ladder and one ``mm_mont_mul`` to leave the Montgomery
    domain.  ``device=None`` means the card, and raises without one."""
    dev = backend.resolve_device(device)
    mp = montgomery_params(n, L)
    nbits = max(e.bit_length() for e in exps) or 1
    a = _limbs(batch_to_limbs([to_mont(b % n, mp) for b in bases], L), dev)
    bits = torch.from_numpy(exponent_bits(exps, nbits)).to(dev)
    one = _limbs(to_limbs(mp["R"] % n, L), dev)
    nl = _limbs(mp["n_limbs"], dev)
    out = mont_exp_op(a, bits, mp["n_limbs"], mp["n0inv"], one, impl=impl)
    # leave the Montgomery domain with one extra multiply by 1
    one_plain = _limbs(batch_to_limbs([1] * len(bases), L), dev)
    out = mont_mul_op(out, one_plain, nl, mp["n0inv"], impl=impl)
    return [from_limbs(row) for row in out.cpu().numpy()]
