"""The port's limb helpers and threshold Paillier against the JAX
package, exactly.

Keys differ from one keygen to the next (the Shamir coefficients come
from ``secrets``), so both packages run on one key: the reference's
``threshold_keygen`` draws it and ``convert.threshold_from_fields``
carries it across.  Small safe primes keep the tests fast, as in
``tests/test_crypto.py``.  The partial decryptions go through the port's
plain torch Montgomery ladder on the CPU (``device="cpu"``) and through
the reference's Pallas kernel in interpret mode.
"""
import dataclasses

import numpy as np
import pytest

from repro.crypto import limb as JL
from repro.crypto import paillier as JP
from repro_torch.convert import threshold_from_fields
from repro_torch.crypto import limb as PL
from repro_torch.crypto import paillier as PP

P, Q = 1907, 1823


def _randint(rng, bits: int) -> int:
    return int.from_bytes(rng.bytes((bits + 7) // 8), "little") % (1 << bits)


@pytest.mark.parametrize("bits", [17, 192, 1024, 2048])
def test_limb_helpers_match_reference(bits):
    rng = np.random.default_rng(bits)
    n = _randint(rng, bits) | (1 << (bits - 1)) | 1
    L = PL.limbs_needed(n)
    assert L == JL.limbs_needed(n)
    xs = [0, 1, n - 1] + [_randint(rng, bits) % n for _ in range(5)]
    limbs = PL.batch_to_limbs(xs, L)
    assert limbs.dtype == np.uint32 and limbs.max() <= PL.LIMB_MASK
    assert np.array_equal(limbs, JL.batch_to_limbs(xs, L))
    assert PL.batch_from_limbs(limbs) == JL.batch_from_limbs(limbs) == xs
    assert PL.from_limbs(PL.to_limbs(xs[-1], L)) == xs[-1]
    pmp, jmp = PL.montgomery_params(n, L), JL.montgomery_params(n, L)
    assert set(pmp) == set(jmp)
    for k in ("n", "L", "R", "n0inv", "R2"):
        assert pmp[k] == jmp[k], k
    assert np.array_equal(pmp["n_limbs"], jmp["n_limbs"])
    for x in xs:
        assert PL.to_mont(x, pmp) == JL.to_mont(x, jmp)
        assert PL.from_mont(PL.to_mont(x, pmp), pmp) == x
    with pytest.raises(ValueError, match="does not fit"):
        PL.to_limbs(1 << (16 * L), L)
    with pytest.raises(ValueError, match="odd"):
        PL.montgomery_params(n + 1, L)


def test_plain_paillier_matches_reference():
    jpk, jsk = JP.keygen(p=P, q=Q)
    ppk, psk = PP.keygen(p=P, q=Q)
    assert (ppk.n, psk.lam, psk.mu) == (jpk.n, jsk.lam, jsk.mu)
    rng = np.random.default_rng(3)
    for m in (0, 1, 12345, ppk.n - 1):
        r = int(rng.integers(2, ppk.n))
        while np.gcd(r, ppk.n) != 1:
            r += 1
        c = ppk.encrypt(m, r=r)
        assert c == jpk.encrypt(m, r=r)
        assert psk.decrypt(c) == jsk.decrypt(c) == m
        c2 = ppk.encrypt(7, r=r)
        assert ppk.add(c, c2) == jpk.add(c, c2)
        assert ppk.scale(c, 11) == jpk.scale(c, 11)
        assert ppk.rerandomize(c, r=r) == jpk.rerandomize(c, r=r)
    assert psk.decrypt(ppk.encrypt(42)) == 42
    with pytest.raises(ValueError, match="out of range"):
        ppk.encrypt(ppk.n)


@pytest.mark.parametrize("t,c", [(2, 3), (3, 5), (4, 7)])
def test_partial_decrypt_batch_matches_reference(t, c):
    jtp, jshares = JP.threshold_keygen(t=t, c=c, p=P, q=Q)
    tp, shares = threshold_from_fields(
        dataclasses.asdict(jtp), [dataclasses.asdict(s) for s in jshares])
    assert (tp.pk.n, tp.t, tp.c, tp.delta) == (jtp.pk.n, t, c, jtp.delta)
    msg = 31337 % tp.pk.n
    ct = jtp.pk.encrypt(msg)
    want = [(s.index, jtp.partial_decrypt(ct, s)) for s in jshares]
    assert jtp.partial_decrypt_batch(ct, jshares) == want     # JAX kernel
    got = tp.partial_decrypt_batch(ct, shares, device="cpu")
    assert got == want
    assert tp.partial_decrypt_batch(ct, shares, use_kernel=False) == want
    assert tp.partial_decrypt_batch(ct, [], device="cpu") == []
    assert tp.combine(got[:t]) == jtp.combine(want[:t]) == msg
    assert tp.combine(got[c - t:]) == msg                     # any t shares
    with pytest.raises(ValueError, match="distinct shares"):
        tp.combine(got[:t - 1])


def test_threshold_homomorphic_sum_on_the_port_keygen():
    tp, shares = PP.threshold_keygen(t=3, c=5, p=P, q=Q)
    vals = [3, 14, 15, 92, 65]
    agg = None
    for v in vals:
        ct = tp.pk.encrypt(v)
        agg = ct if agg is None else tp.pk.add(agg, ct)
    parts = tp.partial_decrypt_batch(agg, shares[2:5], device="cpu")
    assert tp.combine(parts) == sum(vals)
    # the small-key path draws p, q from the same pool as the reference
    assert PP.threshold_keygen(bits=32, c=5)[0].pk.n == \
        JP.threshold_keygen(bits=32, c=5)[0].pk.n
    assert PP.SMALL_SAFE_PRIMES == JP.SMALL_SAFE_PRIMES


def test_gen_safe_prime():
    for bits in (12, 24, 40):
        p = PP.gen_safe_prime(bits)
        assert p.bit_length() == bits
        assert JP._is_probable_prime(p) and JP._is_probable_prime((p - 1) // 2)
    assert not PP._is_probable_prime(1907 * 1823)
    pk, sk = PP.keygen(bits=48)
    assert sk.decrypt(pk.encrypt(4321)) == 4321
