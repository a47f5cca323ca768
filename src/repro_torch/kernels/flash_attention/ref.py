"""Plain torch version of the flash attention kernel.

A torch copy of the reference's oracle ``attention_ref``
(``repro/kernels/flash_attention/ref.py:10``): naive full-matrix
attention in float32, masked entries at the finite ``-1e30``, output in
q's dtype.  It is what a CPU tensor runs, and what ``chip_smoke.py``
holds the CUDA kernel against on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(Sq: int, Skv: int, causal: bool, window: int,
                   device) -> torch.Tensor:
    """(Sq, Skv) bool: True where query i may attend to key j."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos // window) == (kpos // window)
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd), H % K == 0.  Query head h
    reads kv head h // (H // K).  Returns (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    kk = k.repeat_interleave(G, dim=2)
    vv = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kk.float())
    mask = attention_mask(Sq, Skv, causal, window, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vv.float())
    return o.to(q.dtype)
