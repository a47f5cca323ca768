"""Value domains and histogram binning: the index arithmetic every
secure function shares.

Counterpart of ``repro/funcs/domain.py``, in numpy as there.  Order
statistics over secretly held values cannot inspect the values, so the
functions work on a public uniform grid: a :class:`ValueDomain` maps
node values to grid indices once, locally, and all protocol arithmetic
(bisection intervals, threshold counts, histogram bins) happens in exact
integer index space.  Two nodes holding the same value always take the
same branch.

Histogram binning follows ``np.histogram`` exactly (its edges from
``np.histogram_bin_edges``, right-open bins with a closed last bin).
Out-of-range values are clipped into the range first: a secure aggregate
cannot silently drop a contributor.  The casts happen on the host in
numpy, so a NaN or +-Inf value lands in the same bin as in the JAX
package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.schedules import _require


@dataclasses.dataclass(frozen=True)
class ValueDomain:
    """A public uniform grid of ``steps`` values spanning ``[lo, hi]``
    (both ends on the grid).  ``steps == 1`` is the single value
    ``{lo}``."""
    lo: float
    hi: float
    steps: int

    def __post_init__(self):
        _require(self.steps >= 1,
                 f"ValueDomain needs steps >= 1, got {self.steps}")
        _require(self.steps == 1 or self.hi > self.lo,
                 f"ValueDomain needs hi > lo for steps > 1, got "
                 f"[{self.lo}, {self.hi}] with steps={self.steps}")

    @property
    def bisect_rounds(self) -> int:
        """Static bisection depth: halvings pinning the interval to one
        grid value (``ceil(log2(steps))``)."""
        rounds = 0
        while (1 << rounds) < self.steps:
            rounds += 1
        return rounds

    def value(self, idx: int) -> float:
        """Grid value at ``idx`` (0 -> lo, steps-1 -> hi)."""
        if self.steps == 1:
            return float(self.lo)
        return float(self.lo
                     + idx * (self.hi - self.lo) / (self.steps - 1))

    def index(self, v: float) -> int:
        """Nearest grid index of ``v``, clipped into the domain."""
        return int(self.indices(np.asarray([v]))[0])

    def indices(self, values) -> np.ndarray:
        """Vectorized :meth:`index`: int64 grid indices."""
        v = np.asarray(values, dtype=np.float64)
        if self.steps == 1:
            return np.zeros(v.shape, dtype=np.int64)
        scaled = (v - self.lo) * (self.steps - 1) / (self.hi - self.lo)
        return np.clip(np.rint(scaled), 0, self.steps - 1).astype(np.int64)


def bin_edges(bins: int, lo: float, hi: float) -> np.ndarray:
    """The ``bins + 1`` edges ``np.histogram(range=(lo, hi))`` uses."""
    return np.histogram_bin_edges(np.empty(0), bins=bins, range=(lo, hi))


def bin_index(values, bins: int, lo: float, hi: float) -> np.ndarray:
    """Bin of each value under ``np.histogram`` semantics (right-open
    bins, last bin closed), out-of-range values clipped into the range
    rather than dropped."""
    edges = bin_edges(bins, lo, hi)
    v = np.clip(np.asarray(values, dtype=np.float64), lo, hi)
    idx = np.searchsorted(edges, v, side="right") - 1
    return np.clip(idx, 0, bins - 1).astype(np.int64)
