"""The work of the secure allreduce's kernels, from the protocol's shapes.

Bytes are each input read once and each output written once; integer
operations are 32-bit instructions.  The pad stream is the masking
scheme's: a splitmix64-style mix a counter, keyed a row.  Copied from
the port's own arithmetic at the time the benchmark was written, so a
later change to the program cannot move it.
"""

SPLITMIX_OPS = 9              # add, 3 shifts, 3 xors, 2 multiplies
PAD_OPS = SPLITMIX_OPS + 2    # ctr ^ k1, then + k2
KEY_OPS = 2 * SPLITMIX_OPS + 3   # a row's key: 2 splitmix + xor + mul + xor


def network_exchanges(r: int) -> int:
    """Compare-exchanges of an odd-even transposition sort of r copies."""
    return sum(len(range(p % 2, r - 1, 2)) for p in range(r))


def mask_work(rows: int, T: int) -> tuple:
    """(bytes, integer ops, float ops) of quantize-and-mask over rows of
    T: the floats read and the words written, a row's node id, seed and
    offset; the pad an element and the key a row; clip (2), scale and
    round a float."""
    N = rows * T
    return 8 * N + 12 * rows, N * (PAD_OPS + 1) + rows * KEY_OPS, 4 * N


def unmask_work(rows: int, T: int, n_nodes: int) -> tuple:
    """(bytes, integer ops, float ops) of unmask-and-dequantize: the
    words read and the floats written, a row's seed and offset; the n
    nodes' pads an element (global masking's total pad) and n keys a
    row."""
    N = rows * T
    return (8 * N + 8 * rows,
            N * n_nodes * (PAD_OPS + 1) + rows * n_nodes * KEY_OPS, 4 * N)


def vote_work(r: int, N: int) -> tuple:
    """(bytes, integer ops, float ops) of one voted round over N words:
    r copies and the accumulator read, the result written; the sorting
    network and the add."""
    return 4 * (r + 2) * N, N * (2 * network_exchanges(r) + 1), 0


def voted_rounds(schedule: str, n_clusters: int) -> int:
    """Voted rounds of a schedule over g clusters."""
    g = n_clusters
    if schedule == "ring":
        return g - 1
    k = max(g - 1, 0).bit_length()
    return 2 * k if schedule == "tree" else k
