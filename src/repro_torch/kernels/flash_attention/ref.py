"""Plain torch versions of the flash attention kernels.

``attention_ref`` is a torch copy of the reference's oracle
``attention_ref`` (``repro/kernels/flash_attention/ref.py:10``): naive
full-matrix attention in float32, masked entries at the finite
``-1e30``, output in q's dtype.  ``attention_fwd_ref`` adds the row
log-sum-exp L that the training forward saves, and ``attention_bwd_ref``
is the FlashAttention-2 backward of the reference's custom VJP
(``repro/models/layers.py:172`` ``_flash_core_bwd``) in full-matrix
form: the same delta, P = exp(S - L) and dS = P (dP - delta), in
float32, with dQ carried through the scale 1/sqrt(hd) to the unscaled q.
They are what a CPU tensor runs, and what ``chip_smoke.py`` holds the
CUDA kernels against on the card.
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


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int
            ) -> torch.Tensor:
    """Masked float32 scores (B, H, Sq, Skv) of q / sqrt(hd) against k,
    query head h reading kv head h // (H // K)."""
    G = q.shape[2] // k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    kk = k.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kk)
    mask = attention_mask(q.shape[1], k.shape[1], causal, window, q.device)
    return s.masked_fill(~mask, NEG_INF)


def attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``attention_ref``'s output (contiguous, as the kernel's) and the
    float32 row log-sum-exp L (B, H, Sq) of the masked scores."""
    return (attention_ref(q, k, v, causal=causal, window=window).contiguous(),
            torch.logsumexp(_scores(q, k, causal, window), dim=-1))


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      *, causal: bool = True, window: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtypes from the forward's o and L:
    delta = rowsum(dO o O), P = exp(S - L), dS = P (dP - delta), dV = P^T
    dO, dK = dS^T (q / sqrt(hd)), dQ = dS K / sqrt(hd); dK and dV summed
    over each kv head's query heads in float32."""
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    p = torch.exp(_scores(q, k, causal, window) - lse[..., None])
    dof = do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)          # (B, H, Sq)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof,
                      v.float().repeat_interleave(G, dim=2))
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float() * scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds,
                      k.float().repeat_interleave(G, dim=2)) * scale

    def by_kv_head(t):
        return t.reshape(B, Skv, K, G, hd).sum(3)

    return (dq.to(q.dtype), by_kv_head(dk).to(k.dtype),
            by_kv_head(dv).to(v.dtype))
