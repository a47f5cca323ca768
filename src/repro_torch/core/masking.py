"""Fixed-point quantization + PRF masking over the ring Z_{2^32}.

Counterpart of ``repro/core/masking.py``: values are quantized to signed
fixed point and reinterpreted as uint32 words (int32 storage, see
``kernels/secure_agg/secure_agg.py``); addition mod 2^32 of masked values
is masked addition; one-time pads are the splitmix32 streams keyed by
(session seed, node id) and indexed by global flat position.

Masking modes: ``global`` (pad_i = PRF(key, i), removed in one n-way
subtraction at the end), ``pairwise`` (pads cancel inside each cluster)
and ``none`` (quantization only).

:func:`reference_aggregate` is the plain oracle the engine is held
against; it uses the unrolled per-pair pad, not the fused kernel form.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.secure_agg.ref import dequantize_f32, quantize_f32
from repro_torch.kernels.secure_agg.secure_agg import (M32,
                                                       PAIRWISE_KEY_BASE,
                                                       narrow, pad_stream,
                                                       wide)


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    n_nodes: int
    clip: float = 1.0            # values are clipped to [-clip, clip]
    guard_bits: int = 2          # extra headroom on top of ceil(log2(n))
    mode: str = "global"         # global | pairwise | none
    cluster_size: int = 4        # for pairwise cancellation groups
    seed: int = 0x5EC0_A66

    @property
    def frac_bits(self) -> int:
        head = max(1, math.ceil(math.log2(max(self.n_nodes, 2)))) + self.guard_bits
        return 31 - head

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits) / self.clip


def quantize(cfg: MaskConfig, x: torch.Tensor) -> torch.Tensor:
    """float -> int32 words of the uint32 fixed point (round half even)."""
    return quantize_f32(x, cfg.scale, cfg.clip)


def dequantize(cfg: MaskConfig, q: torch.Tensor) -> torch.Tensor:
    return dequantize_f32(q, cfg.scale)


def _ctr(shape, offset: int, device) -> torch.Tensor:
    n = math.prod(shape)
    return (torch.arange(n, dtype=torch.int64, device=device)
            + offset) & M32


def _pad(cfg: MaskConfig, key_id: int, shape, offset: int, device
         ) -> torch.Tensor:
    """Wide counter-based pad over the flat positions of ``shape``."""
    return pad_stream(cfg.seed & M32, key_id & M32,
                      _ctr(shape, offset, device)).reshape(shape)


def pairwise_pad(cfg: MaskConfig, node_id: int, shape, offset: int = 0,
                 device=None) -> torch.Tensor:
    """Wide pairwise-cancelling pad of ``node_id`` within its cluster:
    mask_i = sum_{j in cluster, j>i} PRF(ij) - sum_{j<i} PRF(ij)."""
    c = cfg.cluster_size
    cluster, member = divmod(int(node_id), c)
    total = torch.zeros(shape, dtype=torch.int64, device=device)
    for other in range(c):
        if other == member:
            continue
        lo, hi = min(member, other), max(member, other)
        pair_id = cluster * c * c + lo * c + hi
        p = _pad(cfg, pair_id + PAIRWISE_KEY_BASE, shape, offset, device)
        total = (total + (p if member < other else -p)) & M32
    return total


def mask(cfg: MaskConfig, q: torch.Tensor, node_id: int,
         offset: int = 0) -> torch.Tensor:
    """Apply node ``node_id``'s pad to int32 words ``q``."""
    if cfg.mode == "none":
        return q
    if cfg.mode == "global":
        pad = _pad(cfg, int(node_id), q.shape, offset, q.device)
    elif cfg.mode == "pairwise":
        pad = pairwise_pad(cfg, node_id, q.shape, offset, q.device)
    else:
        raise ValueError(cfg.mode)
    return narrow(wide(q) + pad)


def unmask_total(cfg: MaskConfig, agg: torch.Tensor,
                 offset: int = 0) -> torch.Tensor:
    """Remove the aggregate pad (the "threshold decryption")."""
    if cfg.mode in ("none", "pairwise"):
        return agg  # pairwise pads cancel within clusters by construction
    total = torch.zeros(agg.shape, dtype=torch.int64, device=agg.device)
    for i in range(cfg.n_nodes):
        total = (total + _pad(cfg, i, agg.shape, offset, agg.device)) & M32
    return narrow(wide(agg) - total)


def reference_aggregate(cfg: MaskConfig, xs: torch.Tensor) -> torch.Tensor:
    """xs: (n_nodes, ...) floats -> exact masked-sum-unmasked result.
    Nodes are folded in one at a time, so only one node's payload is
    widened at once."""
    n = xs.shape[0]
    if n != cfg.n_nodes:
        raise ValueError(f"xs has {n} nodes, config {cfg.n_nodes}")
    agg = torch.zeros(xs.shape[1:], dtype=torch.int64, device=xs.device)
    for i in range(n):
        agg = (agg + wide(mask(cfg, quantize(cfg, xs[i]), i))) & M32
    return dequantize(cfg, unmask_total(cfg, narrow(agg)))


def quantization_error_bound(cfg: MaskConfig) -> float:
    """Worst-case |secure_sum - true_sum| per element."""
    return 0.5 * cfg.n_nodes / cfg.scale
