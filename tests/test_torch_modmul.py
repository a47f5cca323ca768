"""The port's Montgomery multiply and modular exponentiation against the
JAX package, exactly.

The same operands, drawn from a seeded numpy generator, go through
``repro.kernels.modmul`` (the Pallas kernel in interpret mode on the CPU,
as ``tests/test_kernels.py`` runs it) and through
``repro_torch.kernels.modmul`` on CPU tensors, which run the plain torch
version of the CUDA kernel.  Limbs and integers are compared for
equality: the arithmetic is exact, so there is no tolerance.  The CUDA
kernel is held against the same plain version on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.crypto.limb import montgomery_params as j_montgomery_params
from repro.kernels import modmul as J
from repro_torch.crypto.limb import (LIMB_BITS, batch_to_limbs, limbs_needed,
                                     montgomery_params, to_limbs, to_mont)
from repro_torch.kernels import backend
from repro_torch.kernels import modmul as P
from repro_torch.kernels.modmul.ops import exponent_bits


def _randint(rng, bits: int) -> int:
    return int.from_bytes(rng.bytes((bits + 7) // 8), "little") % (1 << bits)


def _modulus(rng, bits: int) -> int:
    return _randint(rng, bits) | (1 << (bits - 1)) | 1


def _operands(rng, n: int, batch: int) -> list[int]:
    """Values below n, led by the edge rows 0, 1, n - 1 and R mod n."""
    R = 1 << (LIMB_BITS * limbs_needed(n))
    edges = [0, 1, n - 1, R % n]
    vals = [_randint(rng, n.bit_length()) % n for _ in range(batch)]
    return (edges + vals)[:batch] if batch >= len(edges) else vals


def _torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int32))


@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("bits", [64, 256, 512])
def test_mont_mul_matches_reference(bits, batch):
    rng = np.random.default_rng(bits * 1000 + batch)
    n = _modulus(rng, bits)
    L = limbs_needed(n)
    assert L == {64: 8, 256: 16, 512: 32}[bits]
    mp = montgomery_params(n, L)
    a = batch_to_limbs(_operands(rng, n, batch), L)
    b = batch_to_limbs(_operands(rng, n, batch)[::-1], L)
    jmp = j_montgomery_params(n, L)
    want = np.asarray(J.mont_mul_op(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(jmp["n_limbs"]),
                                    jmp["n0inv"]))
    got = P.mont_mul_op(_torch(a), _torch(b), _torch(mp["n_limbs"]),
                        mp["n0inv"])
    assert got.dtype == torch.int32 and tuple(got.shape) == (batch, L)
    got = got.numpy().astype(np.uint32)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(J.mont_mul_ref(
        a, b, jmp["n_limbs"], jmp["n0inv"])))
    assert np.array_equal(got, P.mont_mul_int(a, b, n, L))
    assert np.array_equal(P.mont_mul_ref(a, b, mp["n_limbs"], mp["n0inv"]
                                         ).numpy().astype(np.uint32), got)


def test_modexp_and_mont_exp_match_reference():
    """Exponents of 0, 1 and 48 bits in one batch at a 192-bit modulus."""
    rng = np.random.default_rng(192)
    n = _modulus(rng, 192)
    L = limbs_needed(n)
    bases = [_randint(rng, 192) % n for _ in range(6)]
    exps = [0, 1, _randint(rng, 48) | (1 << 47), 0, 1,
            _randint(rng, 48) | (1 << 47)]
    want = [pow(x, e, n) for x, e in zip(bases, exps)]
    assert J.modexp_ints(bases, exps, n, L) == want
    assert P.modexp_ints(bases, exps, n, L, device="cpu") == want

    # the ladder itself, in the Montgomery domain, limb for limb
    mp = montgomery_params(n, L)
    a = batch_to_limbs([to_mont(x, mp) for x in bases], L)
    bits = exponent_bits(exps, 48)
    one = to_limbs(mp["R"] % n, L)
    jwant = np.asarray(J.mont_exp_op(
        jnp.asarray(a), jnp.asarray(bits.astype(np.uint32)),
        jnp.asarray(mp["n_limbs"]), jnp.uint32(mp["n0inv"]),
        jnp.asarray(one)))
    got = P.mont_exp_op(_torch(a), torch.from_numpy(bits),
                        _torch(mp["n_limbs"]), mp["n0inv"], _torch(one))
    assert np.array_equal(got.numpy().astype(np.uint32), jwant)


def test_exponent_bits_msb_first():
    bits = exponent_bits([0, 1, 6, 2 ** 47 + 1], 48)
    assert bits.shape == (4, 48) and bits.dtype == np.int32
    assert bits[0].sum() == 0 and bits[1, -1] == 1 and bits[1].sum() == 1
    assert list(bits[2, -3:]) == [1, 1, 0] and bits[3, 0] == bits[3, -1] == 1


def test_device_none_needs_a_card_and_cuda_needs_cuda_tensors(monkeypatch):
    """Nothing falls back to the CPU: ``device=None`` means the card and
    raises without one, and the CUDA kernel refuses a CPU tensor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.modexp_ints([3], [5], 97, 8)
    a = torch.zeros((2, 8), dtype=torch.int32)
    nl = _torch(to_limbs(97, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.mont_mul_op(a, a, nl, 1, impl="cuda")
    with pytest.raises(ValueError, match="not in"):
        P.mont_mul_op(a, a, nl, 1, impl="pallas")
    assert backend.MONT_MUL.launches == 0


def test_launcher_refusals_raise_value_errors():
    """The kernel's argument limits live in its launcher alone; the
    wrapper turns the launcher's status codes into ``ValueError``s and any
    other non-zero status into a launch failure."""
    from repro_torch.kernels.modmul.ops import _REFUSED
    for rc in (1001, 1002, 1003):
        with pytest.raises(ValueError, match=f"status {rc}"):
            backend.raise_on(rc, "mont_mul", _REFUSED)
    with pytest.raises(RuntimeError, match="failed to launch: status 700"):
        backend.raise_on(700, "mont_mul", _REFUSED)
    backend.raise_on(0, "mont_mul", _REFUSED)
