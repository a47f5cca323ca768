"""Plain torch versions of the three secure-aggregation kernels.

Counterpart of ``repro/kernels/secure_agg/ref.py``.  These are what the
CPU tests hold bit for bit against the JAX package, and what the CUDA
kernels are held against on the card.  The batch dimension is written
out: per-row metadata broadcasts as a ``(B, 1)`` column, so row ``b`` is
bit-identical to a single-row call by construction.  The single-row
functions are ``B = 1``.

Inputs and outputs follow the port's ring convention (int32 words
holding uint32 bits, see ``secure_agg.py``); float payloads are float32.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.kernels.secure_agg.secure_agg import (M32, as_copy_list,
                                                       median_network,
                                                       narrow, pad_stream,
                                                       pairwise_total, wide)


def f32(v: float) -> float:
    """A Python float rounded to float32, exactly representable there."""
    return float(np.float32(v))


def row_meta(B: int, v, device) -> torch.Tensor:
    """Per-row uint32 metadata (int, numpy or int32-word tensor, scalar or
    (B,)) -> wide (B, 1) int64 column on ``device``."""
    if isinstance(v, torch.Tensor):
        t = wide(v.to(device).reshape(-1))
    else:
        a = np.asarray(v, dtype=np.int64).reshape(-1) & M32
        t = torch.as_tensor(a, dtype=torch.int64, device=device)
    return t.expand(B).reshape(B, 1)


def ctr_stream(T: int, offset: torch.Tensor) -> torch.Tensor:
    """Wide PRF counters ``offset + j mod 2^32`` for j < T; ``offset`` is a
    wide (B, 1) column, the result (B, T)."""
    j = torch.arange(T, dtype=torch.int64, device=offset.device)
    return (offset + j) & M32


def total_pad(n_nodes: int, seed: torch.Tensor, ctr: torch.Tensor
              ) -> torch.Tensor:
    """sum_{i<n_nodes} pad_stream(seed, i, ctr), wide."""
    acc = torch.zeros_like(ctr)
    for i in range(int(n_nodes)):
        acc = (acc + pad_stream(seed, i, ctr)) & M32
    return acc


def quantize_f32(x: torch.Tensor, scale: float, clip: float) -> torch.Tensor:
    """clip to +-clip, times float32(scale), round half to even -> int32."""
    c = f32(clip)
    s = torch.tensor(f32(scale), dtype=torch.float32, device=x.device)
    xq = torch.clamp(x.to(torch.float32), -c, c) * s
    return torch.round(xq).to(torch.int32)


def dequantize_f32(q: torch.Tensor, scale: float) -> torch.Tensor:
    """int32 words -> float32, divided by float32(scale).  The divisor is
    a device tensor: a host-scalar divisor would let the CUDA division
    turn into a product with the reciprocal."""
    s = torch.tensor(f32(scale), dtype=torch.float32, device=q.device)
    return q.to(torch.float32) / s


def mask_encrypt_batch_ref(x: torch.Tensor, node_ids, seeds, scale: float,
                           clip: float, mode: str = "mask", offsets=None,
                           cluster_size: int = 0) -> torch.Tensor:
    """(B, T) float -> (B, T) int32 words: quantize, then add the pad of
    mode ``mask`` (stream (seeds[b], node_ids[b])), ``pairwise`` (the
    cluster-cancelling pad) or ``quantize`` (none)."""
    B, T = x.shape
    q = quantize_f32(x, scale, clip)
    if mode == "quantize":
        return q
    dev = x.device
    sd = row_meta(B, seeds, dev)
    ctr = ctr_stream(T, row_meta(B, 0 if offsets is None else offsets, dev))
    nid = row_meta(B, node_ids, dev)
    if mode == "mask":
        pad = pad_stream(sd, nid, ctr)
    elif mode == "pairwise":
        if cluster_size < 1:
            raise ValueError("pairwise mode needs cluster_size >= 1")
        pad = pairwise_total(sd, nid, ctr, cluster_size)
    else:
        raise ValueError(f"unknown mask mode {mode!r}")
    return narrow(wide(q) + pad)


def unmask_decrypt_batch_ref(agg: torch.Tensor, n_nodes: int, seeds,
                             scale: float, mode: str = "mask",
                             offsets=None) -> torch.Tensor:
    """(B, T) int32 words -> (B, T) float32: mode ``mask`` subtracts the
    n-way total pad of stream seeds[b]; ``dequantize`` only dequantizes."""
    B, T = agg.shape
    if mode == "mask":
        dev = agg.device
        ctr = ctr_stream(T, row_meta(B, 0 if offsets is None else offsets,
                                     dev))
        agg = narrow(wide(agg) - total_pad(n_nodes, row_meta(B, seeds, dev),
                                           ctr))
    elif mode != "dequantize":
        raise ValueError(f"unknown unmask mode {mode!r}")
    return dequantize_f32(agg, scale)


def vote_combine_ref(copies: Union[torch.Tensor, Sequence[torch.Tensor]],
                     acc: torch.Tensor) -> torch.Tensor:
    """acc + elementwise median of r (odd) copies, in unsigned order."""
    copies = as_copy_list(copies)
    if len(copies) % 2 != 1:
        raise ValueError("vote redundancy must be odd")
    med = median_network([wide(c) for c in copies])
    return narrow(wide(acc) + med)


def mask_encrypt_ref(x, node_id, seed, scale, clip, mode="mask", offset=0,
                     cluster_size=0):
    return mask_encrypt_batch_ref(x[None], node_id, seed, scale, clip,
                                  mode=mode, offsets=offset,
                                  cluster_size=cluster_size)[0]


def unmask_decrypt_ref(agg, n_nodes, seed, scale, mode="mask", offset=0):
    return unmask_decrypt_batch_ref(agg[None], n_nodes, seed, scale,
                                    mode=mode, offsets=offset)[0]
