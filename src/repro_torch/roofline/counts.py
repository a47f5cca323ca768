"""The work each of the port's kernels does: bytes moved and operations,
from its shapes alone.

One home for the counts that ``chip_smoke.py``'s kernel table divides
into the card's rates for its bounds and that each kernel wrapper's meta
route records (``kernels.backend.record_meta``) for the dry run, so both
count the same work.  Bytes are each input read once and each output
written once; FLOPs count a multiply-add as two; the integer kernels'
operations are 32-bit instructions.
"""
from __future__ import annotations

SPLITMIX_OPS = 9              # add, 3 shifts, 3 xors, 2 multiplies
PAD_OPS = SPLITMIX_OPS + 2    # ctr ^ k1, then + k2
# the per-row key derivation: 2 splitmix + xor + mul + xor
KEY_OPS = 2 * SPLITMIX_OPS + 3
SSD_KERNEL_CHUNK = 256        # the CUDA scan's chunk length


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


def _causal_rows(r0: int, r1: int, k0: int, k1: int) -> int:
    """Sum over query rows i in [r0, r1) of the keys j in [k0, k1) with
    j <= i."""
    def upto(n):           # sum over i < n of clamp(i + 1 - k0, 0, k1 - k0)
        if n <= k0:
            return 0
        m = min(n, k1)                 # rows i < m: i + 1 - k0 in 1..m-k0
        tri = (m - k0) * (m - k0 + 1) // 2
        return tri + max(0, n - m) * (k1 - k0)
    return upto(r1) - upto(r0)


def flash_pairs(Sq: int, Skv: int, causal: bool, window: int = 0) -> int:
    """The (query, key) pairs the masks allow: key j for query i where
    j <= i (causal) and j // window == i // window (a window)."""
    if window <= 0:
        return _causal_rows(0, Sq, 0, Skv) if causal else Sq * Skv
    total = 0
    for b in range(0, -(-max(Sq, 1) // window)):
        r0, r1 = b * window, min((b + 1) * window, Sq)
        k0, k1 = b * window, min((b + 1) * window, Skv)
        if k0 >= k1:
            continue
        total += (_causal_rows(r0, r1, k0, k1) if causal
                  else (r1 - r0) * (k1 - k0))
    return total


def flash_fwd_work(B: int, Sq: int, Skv: int, H: int, K: int, hd: int,
                   causal: bool, window: int = 0, elem: int = 2,
                   lse: bool = False) -> tuple[int, int]:
    """(bytes, FLOPs) of the forward: q, k, v read and o written in
    ``elem``-byte elements (and the float32 row log-sum-exp L with
    ``lse``); two products over the allowed pairs."""
    nbytes = elem * (2 * B * Sq * H * hd + 2 * B * Skv * K * hd)
    if lse:
        nbytes += 4 * B * H * Sq
    return nbytes, 4 * B * H * hd * flash_pairs(Sq, Skv, causal, window)


def flash_bwd_work(B: int, Sq: int, Skv: int, H: int, K: int, hd: int,
                   causal: bool, window: int = 0, elem: int = 2
                   ) -> tuple[int, int]:
    """(bytes, FLOPs) of the backward: q, o, dO, k, v and L read, dq, dk
    and dv written; five products over the allowed pairs."""
    nbytes = elem * (3 * B * Sq * H * hd + 2 * B * Skv * K * hd) \
        + 4 * B * H * Sq + elem * (B * Sq * H * hd + 2 * B * Skv * K * hd)
    return nbytes, 10 * B * H * hd * flash_pairs(Sq, Skv, causal, window)


# ---------------------------------------------------------------------------
# The SSD scan
# ---------------------------------------------------------------------------


def ssd_flops_at(Bsz: int, S: int, H: int, P: int, N: int, Q: int) -> int:
    """FLOPs of the split scan in chunks of Q (S padded to a multiple):
    the lower triangle of C B^T once per batch row and chunk, shared by
    its H heads; per head the lower triangle of (L o C B^T)(x dt), the
    state's two products, C state^T and (x dt)^T B, and the state
    passing's multiply-add per state element and chunk boundary."""
    nc = -(-S // Q)
    Sp = nc * Q
    tri = Sp * (Q + 1) // 2
    return 2 * (Bsz * tri * N
                + Bsz * H * (tri * P + 2 * Sp * N * P + (nc - 1) * P * N))


def ssd_flops(Bsz: int, S: int, H: int, P: int, N: int) -> tuple[int, int]:
    """The least FLOPs the scan needs at these shapes, over every chunk
    length Q (the work depends on Q, the result does not), and that Q."""
    return min((ssd_flops_at(Bsz, S, H, P, N, Q), Q) for Q in range(1, S + 1))


def ssd_bwd_flops_at(Bsz: int, S: int, H: int, P: int, N: int,
                     Q: int) -> int:
    """FLOPs of the SSD backward in chunks of Q (S padded to a multiple):
    the lower triangles of C B^T and of the two uses of M = sum_h dt E o
    dy x^T (dB and dC) once per batch row and chunk, N a pair each; per
    head five state products (the forward's chunk states again -- they
    are not among the function's inputs -- u_c, gh_c B, gh_c^T x and h^T
    dy; the last two are products of depth H P once per batch row, the
    same count), the lower triangles of D = dy x^T and of G's use (P a
    pair each), the two state passes, <gh_c, h_c> a chunk and the two row
    dots (dy . y, x . r)."""
    nc = -(-S // Q)
    Sp = nc * Q
    tri = Sp * (Q + 1) // 2
    return 2 * (3 * Bsz * tri * N + Bsz * H * (
        5 * Sp * N * P + tri * 2 * P + 2 * (nc - 1) * P * N
        + nc * P * N + 2 * Sp * P))


def ssd_bwd_flops(Bsz: int, S: int, H: int, P: int, N: int
                  ) -> tuple[int, int]:
    """The least FLOPs the backward needs at these shapes over every chunk
    length Q, and that Q."""
    return min((ssd_bwd_flops_at(Bsz, S, H, P, N, Q), Q)
               for Q in range(1, S + 1))


def ssd_bytes(Bsz: int, S: int, H: int, P: int, N: int) -> int:
    """x and y, dt, A, B and C once each, the final state written once
    (float32)."""
    return 4 * (2 * Bsz * S * H * P + Bsz * S * H + H + 2 * Bsz * S * N
                + Bsz * H * P * N)


def ssd_bwd_bytes(Bsz: int, S: int, H: int, P: int, N: int) -> int:
    """x, y, dy, dx, dt, ddt, A, dA, B, C, dB and dC once each
    (float32)."""
    big = 2 * Bsz * S * H * P + Bsz * S * H
    return 4 * (2 * big + 2 * Bsz * H + 4 * Bsz * S * N)


# ---------------------------------------------------------------------------
# The secure aggregation kernels
# ---------------------------------------------------------------------------


def network_exchanges(r: int) -> int:
    """Compare-exchanges of the vote's odd-even sorting network over r
    copies."""
    return sum(len(range(p % 2, r - 1, 2)) for p in range(r))


def mask_work(B: int, T: int) -> tuple[int, int, int]:
    """(bytes, integer ops, float ops) of ``mask_encrypt`` over B rows of
    T: x read and the words written, a row's node id, seed and offset;
    the pad per element and the key per row; clip (2), scale and round a
    float."""
    N = B * T
    return 8 * N + 12 * B, N * (PAD_OPS + 1) + B * KEY_OPS, N * 4


def unmask_work(B: int, T: int, n_nodes: int) -> tuple[int, int, int]:
    """(bytes, integer ops, float ops) of ``unmask_decrypt``: the words
    read and the floats written, a row's seed and offset; n pads an
    element, n keys a row."""
    N = B * T
    return (8 * N + 8 * B, N * n_nodes * (PAD_OPS + 1)
            + B * n_nodes * KEY_OPS, N * 4)


def vote_work(r: int, N: int) -> tuple[int, int, int]:
    """(bytes, integer ops, float ops) of ``vote_combine``: r copies and
    acc read, the output written; the sorting network and the add."""
    return 4 * (r + 2) * N, N * (2 * network_exchanges(r) + 1), 0


# ---------------------------------------------------------------------------
# Montgomery products
# ---------------------------------------------------------------------------


def product_ops(L: int) -> int:
    """32-bit integer instructions of one Montgomery product on s digits
    (s = L / 2 32-bit digits, or L 16-bit ones for an odd L): s (10 s + 5)
    + 12 s -- per digit and step two low and two high products and the
    64-bit adds of the slots; m and the fold; the lookahead tail."""
    s = L // 2 if L % 2 == 0 else L
    return s * (10 * s + 5) + 12 * s


def mont_mul_work(rows: int, L: int) -> tuple[int, int]:
    """(bytes, 32-bit integer instructions) one Montgomery product of
    ``rows`` rows of L limbs needs: a, b and the output once each and n;
    one product on the kernel's digits a row."""
    return 4 * (3 * rows * L + L), rows * product_ops(L)


def mont_exp_work(rows: int, L: int, nbits: int) -> tuple[int, int]:
    """(bytes, 32-bit integer instructions) the ladder needs for ``rows``
    rows of L limbs and nbits exponent bits: the bases, the output, n,
    R mod n and the bits once each; per row and bit two products on s =
    L / 2 digits of s (10 s + 5) + 12 s instructions each (per digit and
    step two low and two high products and the 64-bit adds of the slots;
    m and the fold; the lookahead tail) and one select a digit."""
    return (4 * (2 * rows * L + 2 * L + rows * nbits),
            rows * nbits * (2 * product_ops(L) + L // 2))
