"""Paillier cryptosystem + (t, c) threshold decryption (Fouque-Poupard-Stern
style, as used by Damgard-Jurik [DJ01] for s = 1), in pure Python bigints.

Port of ``repro/crypto/paillier.py``: the same keys, ciphertexts and
partial decryptions.  Only ``ThresholdPublic.partial_decrypt_batch`` runs
on the card: its batched modular exponentiation goes through the CUDA
Montgomery-multiply kernel (``kernels/modmul``).  Key sizes are
parameterised so tests run with small safe primes while the full-width
run uses 1024-bit moduli like the paper.

Threshold scheme:
  * n = p*q with p = 2p'+1, q = 2q'+1 safe primes; m = p'*q'.
  * secret d: d = 0 (mod m), d = 1 (mod n)  (CRT)
  * d is Shamir-shared mod n*m among c nodes, threshold t.
  * partial decryption of ciphertext ct:  ct_i = ct^(2*Delta*s_i) mod n^2,
    Delta = c! ; combination uses integer Lagrange multipliers 2*lambda_i:
        prod ct_i^(2 lambda_i) = ct^(4 Delta^2 d) = (1+n)^(4 Delta^2 M)
    and M = L(x) * (4 Delta^2)^{-1} mod n,  L(u) = (u-1)/n.
"""
from __future__ import annotations

import dataclasses
import math
import random
import secrets
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# Number theory helpers
# ---------------------------------------------------------------------------


def _is_probable_prime(n: int, rounds: int = 24) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_safe_prime(bits: int) -> int:
    """p = 2q+1 with both prime."""
    while True:
        q = secrets.randbits(bits - 1) | (1 << (bits - 2)) | 1
        if not _is_probable_prime(q):
            continue
        p = 2 * q + 1
        if _is_probable_prime(p):
            return p


SMALL_SAFE_PRIMES = [
    # precomputed small safe primes for fast deterministic tests
    23, 47, 59, 83, 107, 167, 179, 227, 263, 347, 359, 383, 467, 479, 503,
    563, 587, 719, 839, 863, 887, 983, 1019, 1187, 1283, 1307, 1319, 1367,
    1439, 1487, 1523, 1619, 1823, 1907,
]


# ---------------------------------------------------------------------------
# Plain Paillier
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PublicKey:
    n: int

    @property
    def n2(self) -> int:
        return self.n * self.n

    def encrypt(self, m: int, r: Optional[int] = None) -> int:
        if not 0 <= m < self.n:
            raise ValueError("plaintext out of range")
        if r is None:
            while True:
                r = secrets.randbelow(self.n)
                if r > 0 and math.gcd(r, self.n) == 1:
                    break
        # (1+n)^m reduces to 1 + m*n mod n^2
        return (1 + m * self.n) % self.n2 * pow(r, self.n, self.n2) % self.n2

    def add(self, c1: int, c2: int) -> int:
        """Dec(add(c1,c2)) = m1 + m2  (the (+) of Definition 4)."""
        return c1 * c2 % self.n2

    def scale(self, c: int, k: int) -> int:
        """Dec(scale(c,k)) = k*m  (the (.) of Definition 4: affine)."""
        return pow(c, k, self.n2)

    def rerandomize(self, c: int, r: Optional[int] = None) -> int:
        if r is None:
            r = secrets.randbelow(self.n - 1) + 1
        return c * pow(r, self.n, self.n2) % self.n2


@dataclasses.dataclass
class SecretKey:
    pk: PublicKey
    lam: int       # lcm(p-1, q-1)
    mu: int        # (L(g^lam mod n^2))^{-1} mod n

    def decrypt(self, c: int) -> int:
        n, n2 = self.pk.n, self.pk.n2
        u = pow(c, self.lam, n2)
        return (u - 1) // n * self.mu % n


def _distinct_safe_primes(bits: int) -> tuple[int, int]:
    p = gen_safe_prime(bits // 2)
    q = gen_safe_prime(bits // 2)
    while q == p:
        q = gen_safe_prime(bits // 2)
    return p, q


def keygen(bits: int = 256, p: Optional[int] = None,
           q: Optional[int] = None) -> tuple[PublicKey, SecretKey]:
    if p is None or q is None:
        p, q = _distinct_safe_primes(bits)
    n = p * q
    lam = (p - 1) * (q - 1) // math.gcd(p - 1, q - 1)
    pk = PublicKey(n)
    u = pow(1 + n, lam, n * n)
    mu = pow((u - 1) // n, -1, n)
    return pk, SecretKey(pk, lam, mu)


# ---------------------------------------------------------------------------
# Threshold Paillier
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ThresholdShare:
    index: int       # 1-based share index
    value: int       # s_i = f(index) mod n*m


@dataclasses.dataclass
class ThresholdPublic:
    pk: PublicKey
    t: int           # threshold
    c: int           # number of shareholders
    delta: int       # c!

    def partial_decrypt(self, ct: int, share: ThresholdShare) -> int:
        return pow(ct, 2 * self.delta * share.value, self.pk.n2)

    def partial_decrypt_batch(self, ct: int,
                              shares: Sequence[ThresholdShare], *,
                              use_kernel: bool = True, device=None,
                              ) -> list[tuple[int, int]]:
        """All shareholders' partial decryptions of ``ct`` in one batched
        modular exponentiation (``kernels/modmul.modexp_ints``: each row
        runs one share's square-and-multiply over the Montgomery-multiply
        kernel).  ``device=None`` means the card, and raises without one;
        ``device="cpu"`` runs the plain torch version.
        ``use_kernel=False`` is per-share Python ``pow`` (identical
        values)."""
        if not shares or not use_kernel:
            return [(sh.index, self.partial_decrypt(ct, sh))
                    for sh in shares]
        from repro_torch.crypto.limb import limbs_needed
        from repro_torch.kernels.modmul.ops import modexp_ints
        exps = [2 * self.delta * sh.value for sh in shares]
        outs = modexp_ints([ct % self.pk.n2] * len(shares), exps, self.pk.n2,
                           limbs_needed(self.pk.n2), device=device)
        return [(sh.index, o) for sh, o in zip(shares, outs)]

    def combine(self, ct_parts: Sequence[tuple[int, int]]) -> int:
        """ct_parts: [(index, partial)] with >= t distinct indices."""
        if len({i for i, _ in ct_parts}) < self.t:
            raise ValueError(f"combine needs {self.t} distinct shares")
        parts = list(ct_parts)[: self.t]
        n, n2 = self.pk.n, self.pk.n2
        x = 1
        for i, ci in parts:
            lam = self.delta  # integer Lagrange: Delta * prod_{j!=i} j/(j-i)
            for j, _ in parts:
                if j != i:
                    lam = lam * j // (j - i)
            e = 2 * lam
            if e < 0:
                ci = pow(ci, -1, n2)
                e = -e
            x = x * pow(ci, e, n2) % n2
        return (x - 1) // n * pow(4 * self.delta ** 2, -1, n) % n


def threshold_keygen(bits: int = 256, t: Optional[int] = None, c: int = 5,
                     p: Optional[int] = None, q: Optional[int] = None,
                     ) -> tuple[ThresholdPublic, list[ThresholdShare]]:
    """Trusted-dealer threshold keygen (the dealer is the CA the paper
    already assumes for identities; [NS11] gives a dealerless DKG).
    Requires p, q safe primes; at ``bits <= 32`` they come from a fixed
    draw of ``SMALL_SAFE_PRIMES``, as in the reference."""
    if p is None or q is None:
        if bits <= 32:  # test path: pick from the precomputed pool
            p, q = random.Random(1234).sample(SMALL_SAFE_PRIMES[-12:], 2)
        else:
            p, q = _distinct_safe_primes(bits)
    n = p * q
    m = (p - 1) // 2 * ((q - 1) // 2)
    t = t if t is not None else c // 2 + 1
    # d = 0 mod m, = 1 mod n  (gcd(m, n) = 1)
    d = m * pow(m, -1, n) % (n * m)
    # Shamir share d over Z_{n*m}
    nm = n * m
    coeffs = [d] + [secrets.randbelow(nm) for _ in range(t - 1)]
    shares = []
    for i in range(1, c + 1):
        v = 0
        for a in reversed(coeffs):
            v = (v * i + a) % nm
        shares.append(ThresholdShare(i, v))
    pk = PublicKey(n)
    return ThresholdPublic(pk, t, c, math.factorial(c)), shares
