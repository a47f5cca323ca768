"""The one-warp Montgomery product of ``src/repro_torch/csrc/modmul.cu``,
in the ladder (``mm_mont_exp``) and alone (``mm_mont_mul``): its
arithmetic, emulated on the CPU.

The kernel runs only on the card, so its schedule is emulated here in
Python ints, lane by lane: the CIOS steps on 32-bit digits (16-bit for
an odd L) in 64-bit lazy slots, the one-digit shift between lanes, and
the carry-lookahead tail that resolves carries and the conditional
subtract's borrows with 32-bit ballot masks.  The emulation is held limb
for limb against Python ints (``mont_mul_int``) and the plain torch
version (``mont_mul_block``) at L in {8, 32, 128, 256} and at odd L, as
the standalone multiply ``mm_mont_mul`` (one product, its 16-bit n0inv
lifted to 32 bits in the kernel) at L in {8, 33, 128, 513, 1021}, and as
a ladder against ``mont_exp_op(impl="torch")``, the JAX package's
``mont_exp_op`` and ``pow``.  Exact arithmetic: no tolerance.  The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import modmul as J
from repro_torch.crypto.limb import (LIMB_BITS, LIMB_MASK, batch_from_limbs,
                                     batch_to_limbs, montgomery_params,
                                     n0inv_digit, to_limbs, to_mont)
from repro_torch.kernels import backend
from repro_torch.kernels import modmul as P
from repro_torch.kernels.modmul.ops import (_EXP_REFUSED, exponent_bits,
                                            ladder_n0inv)

LANES = 32
M64 = (1 << 64) - 1


def limbs_to_digits32(limbs: np.ndarray) -> np.ndarray:
    """(..., L) 16-bit limbs, L even -> (..., L / 2) 32-bit digits of the
    same number: the kernel's repacking on entry (``load_digit``)."""
    a = np.asarray(limbs, dtype=np.uint32)
    if a.shape[-1] % 2:
        raise ValueError("32-bit digits need an even number of limbs")
    return a[..., 0::2] | (a[..., 1::2] << np.uint32(LIMB_BITS))


def digits32_to_limbs(digits: np.ndarray) -> np.ndarray:
    """The inverse of :func:`limbs_to_digits32`: the kernel's exit."""
    d = np.asarray(digits, dtype=np.uint32)
    out = np.empty(d.shape[:-1] + (2 * d.shape[-1],), np.uint32)
    out[..., 0::2] = d & np.uint32(LIMB_MASK)
    out[..., 1::2] = d >> np.uint32(LIMB_BITS)
    return out


def layout(L: int) -> tuple[int, int, int]:
    """(digit bits, digits s, digits a lane W) as the launcher picks them:
    32-bit digits for an even L, 16-bit for an odd one; W the least power
    of two with 32 W >= s."""
    db, s = (32, L // 2) if L % 2 == 0 else (16, L)
    W = 1
    while LANES * W < s:
        W *= 2
    return db, s, W


def carry_in(g: list[int], p: list[int]) -> list[int]:
    """Every lane's carry-in from its group generate / propagate bits, as
    the kernel computes it from two ballots: bit l of ((G | P) + G) ^ P
    in 32-bit arithmetic."""
    G = sum(b << lane for lane, b in enumerate(g))
    P_ = sum(b << lane for lane, b in enumerate(p))
    C = ((((G | P_) + G) & 0xFFFFFFFF) ^ P_)
    return [(C >> lane) & 1 for lane in range(LANES)]


def emulate_product(a: list[int], b: list[int], n: list[int], n0inv: int,
                    db: int, s: int, W: int) -> list[int]:
    """One ``mont_product`` of the kernel: a, b, n as s digits of db bits
    (zero padded to 32 W); returns the s digits of a b R^-1 mod n."""
    mask = (1 << db) - 1
    pad = LANES * W
    b = b + [0] * (pad - s)
    n = n + [0] * (pad - s)
    T = [0] * pad                               # position l W + w
    for i in range(s):
        ai = a[i]
        m = ((T[0] + ai * b[0]) & mask) * n0inv & mask
        X = [T[j] + (ai * b[j] & mask) + (m * n[j] & mask)
             for j in range(pad)]
        H = [(ai * b[j] >> db) + (m * n[j] >> db) for j in range(pad)]
        assert max(X) <= M64 and max(H) < 1 << (db + 1)
        fold = X[0] >> db
        assert X[0] & mask == 0                 # the choice of m
        T = [(X[j + 1] if j + 1 < pad else 0) + H[j] for j in range(pad)]
        T[0] += fold
    # 1. digits and their excess one place up
    excess = [t >> db for t in T]
    assert max(excess) < 1 << 12
    t = [(T[j] & mask) + (excess[j - 1] if j else 0) for j in range(pad)]
    x = [v & mask for v in t]
    c = [v >> db for v in t]
    assert set(c) <= {0, 1}
    # 2. the one-bit carries, resolved by lookahead over the lanes
    g, p = [0] * pad, [0] * pad
    for j in range(pad):
        cin = c[j - 1] if j else 0
        g[j] = cin & int(x[j] == mask)
        x[j] = (x[j] + cin) & mask
        p[j] = int(x[j] == mask)
    gl, pl = _groups(g, p, W)
    carry = carry_in(gl, pl)
    for lane in range(LANES):
        cy = carry[lane]
        for w in range(W):
            j = lane * W + w
            co = g[j] | (p[j] & cy)
            x[j] = (x[j] + cy) & mask
            cy = co
        if lane == LANES - 1:
            top = excess[pad - 1] + c[pad - 1] + cy
    over = top != 0 or any(x[j] for j in range(s, pad))
    # 3. the conditional subtract, borrows by the same lookahead
    g = [int(x[j] < n[j]) for j in range(pad)]
    p = [int(x[j] == n[j]) for j in range(pad)]
    gl, pl = _groups(g, p, W)
    borrow = carry_in(gl, pl)
    d = [0] * pad
    borrow_top = None
    for lane in range(LANES):
        bw = borrow[lane]
        for w in range(W):
            j = lane * W + w
            d[j] = (x[j] - n[j] - bw) & mask
            bw = g[j] | (p[j] & bw)
            if j == s - 1:
                borrow_top = bw
    ge_n = borrow_top == 0 or over
    return (d if ge_n else x)[:s]


def _groups(g: list[int], p: list[int], W: int) -> tuple[list, list]:
    gl, pl = [], []
    for lane in range(LANES):
        G, P_ = 0, 1
        for w in range(W):
            j = lane * W + w
            G = g[j] | (p[j] & G)
            P_ &= p[j]
        gl.append(G)
        pl.append(P_)
    return gl, pl


def to_digits(limbs: np.ndarray, db: int) -> list[int]:
    return [int(v) for v in (limbs_to_digits32(limbs) if db == 32
                             else np.asarray(limbs, np.uint32))]


def from_digits(digits: list[int], db: int) -> np.ndarray:
    d = np.asarray(digits, np.uint32)
    return digits32_to_limbs(d) if db == 32 else d


def emulate_ladder(base: np.ndarray, bits: np.ndarray, mp: dict
                   ) -> np.ndarray:
    """``mont_exp_kernel`` for one row: square, multiply, select by mask
    on every bit."""
    L = mp["L"]
    db, s, W = layout(L)
    n0 = ladder_n0inv(mp["n_limbs"], mp["n0inv"], L)
    n = to_digits(mp["n_limbs"], db)
    b = to_digits(base, db)
    acc = to_digits(to_limbs(mp["R"] % mp["n"], L), db)
    for bit in bits:
        sq = emulate_product(acc, acc, n, n0, db, s, W)
        mul = emulate_product(sq, b, n, n0, db, s, W)
        take = -int(bit != 0) & ((1 << db) - 1)
        acc = [(m & take) | (q & ~take & ((1 << db) - 1))
               for m, q in zip(mul, sq)]
    return from_digits(acc, db)


def _modulus(rng, L: int) -> int:
    bits = 16 * L - 3
    return int.from_bytes(rng.bytes(2 * L), "little") % (1 << bits) \
        | (1 << (bits - 1)) | 1


def _below(rng, n: int) -> int:
    return int.from_bytes(rng.bytes((n.bit_length() + 7) // 8 + 8),
                          "little") % n


@pytest.mark.parametrize("L", [8, 32, 128, 256, 9, 33])
def test_emulated_product_matches_mont_mul(L):
    """The kernel's product schedule equals Python ints and the plain
    torch version limb for limb, edge operands (0, 1, n - 1, R mod n)
    included."""
    rng = np.random.default_rng(L)
    n = _modulus(rng, L)
    mp = montgomery_params(n, L)
    db, s, W = layout(L)
    edges = [0, 1, n - 1, mp["R"] % n]
    av = edges + [_below(rng, n) for _ in range(2)]
    bv = [_below(rng, n) for _ in range(2)] + edges[::-1]
    a = batch_to_limbs(av, L)
    b = batch_to_limbs(bv, L)
    n0 = ladder_n0inv(mp["n_limbs"], mp["n0inv"], L)
    got = np.stack([from_digits(emulate_product(
        to_digits(x, db), to_digits(y, db), to_digits(mp["n_limbs"], db),
        n0, db, s, W), db) for x, y in zip(a, b)])
    assert np.array_equal(got, P.mont_mul_int(a, b, n, L))
    want = P.mont_mul_op(torch.from_numpy(a.astype(np.int32)),
                         torch.from_numpy(b.astype(np.int32)),
                         torch.from_numpy(mp["n_limbs"].astype(np.int32)),
                         mp["n0inv"])
    assert np.array_equal(got.astype(np.int32), want.numpy())


def lift_n0inv(n0inv: int, n_low: int) -> int:
    """``mont_mul_kernel``'s lift of the limbs' -n^-1 mod 2^16 to mod 2^32
    by one Newton step from n's low 32-bit digit."""
    return n0inv * (2 + n_low * n0inv) & 0xFFFFFFFF


def emulate_mont_mul(a: np.ndarray, b: np.ndarray, mp: dict) -> np.ndarray:
    """``mont_mul_kernel`` for one row: the limbs packed to the kernel's
    digits, the callers' 16-bit n0inv lifted for 32-bit digits, one
    ``mont_product``, the digits unpacked."""
    L = mp["L"]
    db, s, W = layout(L)
    n = to_digits(mp["n_limbs"], db)
    n0 = int(mp["n0inv"])
    if db == 32:
        n0 = lift_n0inv(n0, n[0])
    return from_digits(emulate_product(to_digits(a, db), to_digits(b, db),
                                       n, n0, db, s, W), db)


@pytest.mark.parametrize("L", [8, 33, 128, 513, 1021])
def test_emulated_mont_mul_kernel_matches_python_ints(L):
    """The standalone multiply as one call of the warp product, at even
    and odd L, the odd ones past the ladder's 511 on the 32-digit lane
    width: limb for limb equal to Python ints, edge operands included."""
    rng = np.random.default_rng(1000 + L)
    n = _modulus(rng, L)
    mp = montgomery_params(n, L)
    db, s, W = layout(L)
    assert (db, W) == {8: (32, 1), 33: (16, 2), 128: (32, 2),
                       513: (16, 32), 1021: (16, 32)}[L]
    if db == 32:
        assert lift_n0inv(int(mp["n0inv"]), n & 0xFFFFFFFF) == \
            n0inv_digit(n, 32)
    edges = [0, 1, n - 1, mp["R"] % n]
    av = edges[:2] + [_below(rng, n)]
    bv = [_below(rng, n)] + edges[2:]
    a = batch_to_limbs(av, L)
    b = batch_to_limbs(bv, L)
    got = np.stack([emulate_mont_mul(x, y, mp) for x, y in zip(a, b)])
    assert np.array_equal(got, P.mont_mul_int(a, b, n, L))


@pytest.mark.parametrize("L", [8, 9])
def test_emulated_ladder_matches_mont_exp_op_and_pow(L):
    """The ladder with its masked select equals the plain version (the
    host loop of two products a bit), the JAX package's ladder and
    ``pow``; exponents 0, 1 and 40 bits long, one batch."""
    rng = np.random.default_rng(100 + L)
    n = _modulus(rng, L)
    mp = montgomery_params(n, L)
    xs = [_below(rng, n) for _ in range(3)]
    exps = [0, 1, _below(rng, 1 << 40) | (1 << 39)]
    bits = exponent_bits(exps, 40)
    base = batch_to_limbs([to_mont(x, mp) for x in xs], L)
    got = np.stack([emulate_ladder(row, rb, mp)
                    for row, rb in zip(base, bits)])
    one = to_limbs(mp["R"] % n, L)
    plain = P.mont_exp_op(torch.from_numpy(base.astype(np.int32)),
                          torch.from_numpy(bits),
                          torch.from_numpy(mp["n_limbs"].astype(np.int32)),
                          mp["n0inv"],
                          torch.from_numpy(one.astype(np.int32)))
    assert np.array_equal(got.astype(np.int32), plain.numpy())
    jwant = np.asarray(J.mont_exp_op(
        jnp.asarray(base), jnp.asarray(bits.astype(np.uint32)),
        jnp.asarray(mp["n_limbs"]), jnp.uint32(mp["n0inv"]),
        jnp.asarray(one)))
    assert np.array_equal(got, jwant)
    R_inv = pow(mp["R"], -1, n)
    assert [v * R_inv % n for v in batch_from_limbs(got)] == \
        [pow(x, e, n) for x, e in zip(xs, exps)]


@pytest.mark.parametrize("L", [8, 128])
def test_limbs_to_digits32_round_trip(L):
    rng = np.random.default_rng(L)
    limbs = rng.integers(0, 1 << 16, size=(5, L), dtype=np.uint32)
    digits = limbs_to_digits32(limbs)
    assert digits.shape == (5, L // 2) and digits.dtype == np.uint32
    assert np.array_equal(digits32_to_limbs(digits), limbs)
    # the same number: digit k is limbs 2k and 2k + 1
    for row_l, row_d in zip(limbs, digits):
        assert sum(int(v) << (32 * k) for k, v in enumerate(row_d)) == \
            sum(int(v) << (16 * k) for k, v in enumerate(row_l))
    with pytest.raises(ValueError, match="even"):
        limbs_to_digits32(limbs[:, :3])


def test_n0inv_of_the_32_bit_digits():
    """-n^-1 mod 2^32 from n's two low limbs; its low half is the 16-bit
    n0inv; an odd L keeps the 16-bit one."""
    rng = np.random.default_rng(7)
    for L in (8, 128):
        n = _modulus(rng, L)
        mp = montgomery_params(n, L)
        n0 = ladder_n0inv(mp["n_limbs"], mp["n0inv"], L)
        assert n0 == n0inv_digit(n, 32)
        assert (n * n0 + 1) % (1 << 32) == 0
        assert n0 & 0xFFFF == int(mp["n0inv"])
        assert ladder_n0inv(torch.from_numpy(mp["n_limbs"].astype(np.int32)),
                            mp["n0inv"], L) == n0
    mp = montgomery_params(_modulus(rng, 9), 9)
    assert ladder_n0inv(mp["n_limbs"], mp["n0inv"], 9) == int(mp["n0inv"])


def test_ladder_wrapper_refuses_what_it_cannot_take():
    """The ladder needs CUDA tensors; the launcher's refusals raise
    ``ValueError``; nothing launched on the CPU."""
    a = torch.zeros((2, 8), dtype=torch.int32)
    bits = torch.zeros((2, 4), dtype=torch.int32)
    nl = torch.from_numpy(to_limbs(97, 8).astype(np.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.mont_exp_op(a, bits, nl, 1, nl, impl="cuda")
    from repro_torch.kernels.modmul.ops import _mont_exp_cuda
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        _mont_exp_cuda(a, bits, nl, 1, nl)
    for rc in _EXP_REFUSED:
        with pytest.raises(ValueError, match=f"status {rc}"):
            backend.raise_on(rc, "mont_exp", _EXP_REFUSED)
    assert backend.MONT_EXP.launches == 0
