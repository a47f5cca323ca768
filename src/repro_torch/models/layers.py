"""Model layer primitives of the port: norms, rotary, GQA attention (full
and chunked-window), the dense MLP, the Mixture-of-Experts MLP (local and
expert-parallel), the Mamba2 SSD mixer.

Counterpart of ``repro/models/layers.py``, for what the dense, MoE,
Mamba2 and cross-attention models use.  Functions are plain functions of
tensors and parameter dicts, with the reference's weight layout (``x @
W``, W of shape ``(in, out)``), so carrying weights across is a copy.  Every prefill goes
through a kernel wrapper: attention through ``flash_attention``, the SSD
scan through ``ssd_chunked``; each launches its CUDA kernel on a CUDA
tensor and runs its plain version on a CPU tensor (or under
``impl="torch"``).  Decode stays plain torch, as it is plain jnp in the
reference.

Tensor parallelism (TP, the ``DistCtx``'s ``tp_axis``) runs where the
reference leaves GSPMD to shard by its ``constrain`` hints: each layer
takes its weights as this rank's slice (``launch.sharding.shard_tree``)
and reads its local sizes off their shapes.  The residual stream enters
each mixer and MLP through ``tp_enter`` (``tp_copy``; under
``seq_parallel`` an all-gather of the sequence) and a row-parallel
product's partial sums leave through ``tp_exit`` (``tp_reduce``; under
``seq_parallel`` a reduce-scatter onto the rank's positions); between
them every gradient is the rank's part, and a replicated weight read
there enters through ``tp_copy``, so its gradient is summed and whole on
every rank: attention on the rank's query heads and the KV heads they
read (``kv_block``; where the heads do not split, each KV group padded
with zero heads, ``q_group`` / ``q_heads``), the flash kernel at the
local H / K, ``wo`` row-parallel, and in decode every head over the
rank's block of the cache's positions, the softmax combined over the
cut (``decode_attention_cut``); the MLP
column- then row-parallel; the MoE's router replicated (every rank
routes alike; its weights through ``tp_copy``), its expert stacks and
shared expert cut on ``f_e``, summed in float32 after the combine; the
Mamba2 mixer on the rank's SSD heads over the whole sequence (its conv
and scan need it), ``in_B`` / ``in_C`` / ``in_dt`` and the B / C
convolutions replicated, its gated RMSNorm's sum of squares summed over
the axis (it averages over the whole ``d_inner``) and ``out_proj``
row-parallel.  ``q_norm``, ``A_log`` and a KV head held by more than one
rank take their gradient summed the same way.  With no TP axis every
collective is the identity.

The MoE's expert products are plain batched products over every slot of
the fixed-capacity buffer, as the reference's einsums (no Pallas kernel
there either).  A cross-attention layer attends from the sequence to the
normed media tokens with no mask and no rope, through the same kernel
wrapper (Sq != Skv), and decodes against the media's K / V, computed
once by the prefill.  Logit soft-capping runs in decode only: a prefill
with it raises, as the reference's does.
Training differentiates through everything here with autograd;
attention's and the SSD scan's backwards are their wrappers' own (CUDA
kernels on the card).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ATTN_CHUNKED, CROSS_ATTN, ModelConfig
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.ssd import ssd_chunked
from repro_torch.runtime.context import (all_reduce_sum, all_to_all,
                                         cache_cut, cut_gather,
                                         ep_group, get_ctx, pool_ids,
                                         pooled, tp_copy, tp_enter,
                                         tp_exit, tp_heads, tp_index,
                                         tp_reduce, tp_size)

NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
def weak_scalar(c: float, dtype: torch.dtype) -> float:
    """The Python scalar ``c`` as it meets a tensor of ``dtype`` in the
    reference: JAX's weak typing first rounds it to that dtype (a
    bfloat16 tensor times ``1 / sqrt(128)`` is times 0.08837890625),
    where torch keeps it at full precision and rounds only the product.
    Multiplying by the rounded value gives the reference's bits: the
    product of two bfloat16 values is exact in torch's float32
    arithmetic, then rounded once, and a float32 tensor's scalar is
    rounded to float32 by torch as well."""
    return torch.tensor(c, dtype=dtype).item()


def _w(p: dict, name: str, dtype: torch.dtype) -> torch.Tensor:
    """A parameter in the compute dtype (a no-op when it already is)."""
    return p[name].to(dtype)


def _device(gen) -> torch.device:
    """Where ``init`` puts its tensors: the generator's device, or the
    ``meta`` device given in its place (shapes only)."""
    return gen if isinstance(gen, torch.device) else gen.device


def _normal(gen, shape, std: float) -> torch.Tensor:
    """N(0, std^2) drawn from ``gen``; on the meta device, the shape
    alone (there is no meta generator)."""
    if isinstance(gen, torch.device):
        return torch.empty(shape, device=gen)
    return torch.randn(shape, generator=gen, device=gen.device) * std


def q_group(cfg: ModelConfig, tp: int) -> int:
    """Query heads a KV group holds over ``tp`` TP ranks: its ``H / K``,
    or, where the ``H`` heads do not split over the ranks (``K < tp``),
    the least ``g' >= H / K`` with ``K g'`` a multiple of ``tp``, the
    group padded with zero heads (llama4-maverick's groups of 5 at TP 16:
    6, so 48 heads, 3 a rank, each rank's inside one group)."""
    H, K = cfg.n_heads, cfg.n_kv_heads
    g = H // K
    if H % tp:
        while (K * g) % tp:
            g += 1
    return g


def q_heads(cfg: ModelConfig, tp: int, idx: int) -> list:
    """The query head of the unpadded model behind each of TP rank
    ``idx``'s heads, in order; None for a zero (pad) head."""
    G, g = cfg.n_heads // cfg.n_kv_heads, q_group(cfg, tp)
    n = cfg.n_kv_heads * g // tp
    return [(h // g) * G + h % g if h % g < G else None
            for h in range(idx * n, (idx + 1) * n)]


def kv_block(cfg: ModelConfig, tp: int, idx: int) -> tuple[int, int]:
    """(first KV head, KV heads) of TP rank ``idx`` of ``tp``: the heads
    that its query heads (``q_heads``) read.  Where ``K < tp`` each KV
    head is held by the ``tp / K`` ranks that read it."""
    K = cfg.n_kv_heads
    if tp == 1:
        return 0, K
    g = q_group(cfg, tp)
    return (idx * (K * g // tp)) // g, max(K // tp, 1)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def make_norm_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    if cfg.norm == "nonparam_ln":
        return {}
    return {"scale": torch.ones((cfg.d_model,), dtype=torch.float32,
                                device=_device(gen))}


def apply_norm(cfg: ModelConfig, params: dict, x: torch.Tensor
               ) -> torch.Tensor:
    """RMSNorm, LayerNorm or the parameter-free LayerNorm: statistics in
    float32 (LayerNorm's variance as max(E[x^2] - mu^2, 0)), applied in
    x's dtype, as the reference."""
    dt = x.dtype
    if cfg.norm == "rmsnorm":
        ms = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + 1e-6).to(dt)
        y = y * params["scale"].to(dt)
    elif cfg.norm in ("layernorm", "nonparam_ln"):
        mu = torch.mean(x.float(), dim=-1, keepdim=True)
        ms = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        var = torch.clamp(ms - torch.square(mu), min=0.0)
        y = (x - mu.to(dt)) * torch.rsqrt(var + 1e-5).to(dt)
        if cfg.norm == "layernorm":
            y = y * params["scale"].to(dt)
    else:
        raise ValueError(cfg.norm)
    return y.to(dt)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """qk-norm: RMS over the head dim, in float32."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)
    return (x * scale).to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs           # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, softcap: float = 0.0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Prefill attention through the kernel wrapper.  q: (B, Sq, H, hd);
    k, v: (B, Skv, K, hd).  The reference's jnp flash rounds the scaled q
    back to q's dtype before its loop (``layers.py:252``); the kernel, like
    the Pallas kernel, scales q in float32 inside, so it is called on the
    unscaled q: in bfloat16 the two differ by one rounding of q, in
    float32 not at all.  ``softcap > 0`` raises, as the reference's
    prefill does: no config it serves soft-caps its prefill."""
    if softcap > 0.0:
        raise NotImplementedError("softcap not used by assigned archs")
    return _flash(q, k, v, causal=causal, window=window, impl=impl)


def _query_groups(q: torch.Tensor, K: int) -> torch.Tensor:
    """The token's scaled q (B, 1, H, hd) as (B, K, H / K, hd), in q's
    dtype: the scale ``1 / sqrt(hd)`` rounded to that dtype first, as
    the reference's ``q * scale`` rounds it (``weak_scalar``)."""
    B, _, H, hd = q.shape
    scale = weak_scalar(1.0 / math.sqrt(hd), q.dtype)
    return (q[:, 0] * scale).reshape(B, K, H // K, hd)


def _masked(s: torch.Tensor, t: int, lo: int, softcap: float
            ) -> torch.Tensor:
    """Float32 scores (..., S) of positions ``[lo, lo + S)``: soft-capped,
    then those after ``t`` masked to ``NEG_INF``."""
    valid = torch.arange(lo, lo + s.shape[-1], device=s.device) <= t
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    return s.masked_fill(~valid, NEG_INF)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, t: int, *,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-token decode attention against a cache, plain torch.

    q: (B, 1, H, hd); caches: (B, S, K, hd); ``t``: current position
    (number of valid cache entries is t+1, the new token already written).
    Products in float32, as the reference's ``preferred_element_type``;
    ``softcap > 0`` caps the float32 scores at +-softcap by tanh before
    the mask.
    """
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    s = torch.einsum("bkgh,bskh->bkgs", _query_groups(q, K).float(),
                     k_cache.float())
    p = torch.softmax(_masked(s, t, 0, softcap), dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def _f32_heads_major(t: torch.Tensor) -> torch.Tensor:
    """A cache block (B, S, K, hd) as float32 (B, K, S, hd), contiguous:
    one copy, which the products then read in place."""
    return t.transpose(1, 2).to(torch.float32, copy=True,
                                 memory_format=torch.contiguous_format)


def decode_attention_cut(q: torch.Tensor, k_block: torch.Tensor,
                         v_block: torch.Tensor, t: int, *, lo: int,
                         softcap: float = 0.0) -> torch.Tensor:
    """``decode_attention`` over a cache cut on its positions: this
    rank's block (B, S_b, K, hd) holds positions ``[lo, lo + S_b)`` of
    every head, q (B, 1, H, hd) every query head.  Each rank's scores
    are masked at their global positions, and each row's max m_j and sum
    l_j of ``exp(s - m_j)`` over the block give the whole row's max M and
    sum L = ``sum_j l_j exp(m_j - M)``.

    The reference rounds the normalized p to the cache's dtype before
    its product with V, over the whole row.  So in a narrower dtype one
    gather of (m_j, l_j) (``tp_decode_stats``) comes first; then each
    rank's ``p = exp(s - M) / L``, rounded, times its V in float32 is
    gathered (``tp_decode_combine``) and summed in block order.  In
    float32 the rounding is the identity, and one gather of each block's
    unnormalized product with V beside (l_j, m_j) is combined exactly:
    ``sum_j w_j o_j / sum_j w_j l_j``, ``w_j = exp(m_j - M)``.  A block
    with no valid position adds exactly zero (its scores are the finite
    ``NEG_INF``, so its weight and its p underflow to 0).  Returns every
    head's output, the same on every rank of the cut."""
    B, _, H, hd = q.shape
    K = k_block.shape[2]
    ctx = get_ctx()
    s = torch.matmul(_query_groups(q, K).float(),
                     _f32_heads_major(k_block).transpose(-1, -2))
    s = _masked(s, t, lo, softcap)
    m = s.amax(-1, keepdim=True)
    v = _f32_heads_major(v_block)
    if v_block.dtype == torch.float32:
        p = s.sub_(m).exp_()
        parts = cut_gather(ctx, torch.cat(
            [torch.matmul(p, v), p.sum(-1, keepdim=True), m], dim=-1))
        w = torch.exp(parts[..., -1:] - parts[..., -1:].amax(0))
        ol = (parts[..., :-1] * w).sum(0)
        o = ol[..., :hd] / ol[..., hd:]
    else:
        ml = cut_gather(ctx, torch.cat(
            [m, torch.exp(s - m).sum(-1, keepdim=True)], dim=-1),
            kind="tp_decode_stats")
        top = ml[..., :1].amax(0)
        total = (ml[..., 1:] * torch.exp(ml[..., :1] - top)).sum(0)
        p = (s.sub_(top).exp_() / total).to(v_block.dtype)
        o = cut_gather(ctx, torch.matmul(p.float(), v)).sum(0)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def make_attn_params(cfg: ModelConfig, gen: torch.Generator,
                     cross: bool = False) -> dict:
    """Self- or cross-attention weights: the same shapes for both (a
    cross layer's wk, wv read the media, of width d_model), as the
    reference draws them."""
    d, hd, H, K = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    std = d ** -0.5
    dev = _device(gen)

    def normal(shape, s):
        return _normal(gen, shape, s)

    p = {"wq": normal((d, H * hd), std), "wk": normal((d, K * hd), std),
         "wv": normal((d, K * hd), std), "wo": normal((H * hd, d), std)}
    if cfg.attn_bias:
        p["bq"] = torch.zeros((H * hd,), device=dev)
        p["bk"] = torch.zeros((K * hd,), device=dev)
        p["bv"] = torch.zeros((K * hd,), device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=dev)
        p["k_norm"] = torch.ones((hd,), device=dev)
    return p


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, kv_src: torch.Tensor,
         dtype: torch.dtype):
    """q (B, Sq, H_loc, hd) from x, k and v (B, Skv, K_loc, hd) from
    ``kv_src``: the rank's heads, as many as its weights hold (zero pad
    heads included, whose q is zero).  x enters through ``tp_enter`` (the
    whole sequence, gathered under ``seq_parallel``), ``kv_src`` when it
    is another tensor (the media) through ``tp_copy``."""
    ctx = get_ctx()
    hd = cfg.hd
    xt = tp_enter(ctx, x)
    kt = xt if kv_src is x else tp_copy(ctx, kv_src)
    B, Sq, _ = xt.shape
    Skv = kt.shape[1]
    # a KV head held by tp / K ranks: its gradient summed over them
    tp, K = tp_size(ctx), cfg.n_kv_heads
    span = tp // K if K < tp else 0

    def kvw(name):
        w = _w(p, name, dtype)
        return tp_copy(ctx, w, span) if span else w

    q = xt @ _w(p, "wq", dtype)
    k = kt @ kvw("wk")
    v = kt @ kvw("wv")
    if cfg.attn_bias:
        q = q + _w(p, "bq", dtype)
        k = k + kvw("bk")
        v = v + kvw("bv")
    q = q.reshape(B, Sq, -1, hd)
    k = k.reshape(B, Skv, -1, hd)
    v = v.reshape(B, Skv, -1, hd)
    if cfg.qk_norm:
        q = rms_head_norm(tp_copy(ctx, p["q_norm"]), q)
        k = rms_head_norm(tp_copy(ctx, p["k_norm"]), k)
    return q, k, v


def _attn_out(p: dict, o: torch.Tensor, dtype: torch.dtype
              ) -> torch.Tensor:
    """The rank's heads o (B, S, H_loc, hd) through its rows of ``wo``,
    summed over the TP axis (``tp_exit``).  A pad head's rows of ``wo``
    are zero: its output (the mean of V: its q is zero) adds nothing."""
    B, S = o.shape[:2]
    return tp_exit(get_ctx(), o.reshape(B, S, -1) @ _w(p, "wo", dtype))


def self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                   mixer: str, positions: Optional[torch.Tensor] = None,
                   impl: Optional[str] = None):
    """Self-attention over the full sequence x (B, S, D): (output, k, v),
    k and v (B, S, K_loc, hd) after rope, for a prefill's cache."""
    dtype = x.dtype
    q, k, v = _qkv(cfg, p, x, x, dtype)
    S = q.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.attn_window if mixer == ATTN_CHUNKED else 0
    out = flash_attention(q, k, v, causal=cfg.causal, window=window,
                          softcap=cfg.logit_softcap, impl=impl)
    return _attn_out(p, out, dtype), k, v


def attn_forward(cfg: ModelConfig, p: dict, x: torch.Tensor, *, mixer: str,
                 media: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill). x: (B, S, D); a
    cross-attention layer's ``media`` (B, M, D), already normed: q from x,
    k and v from the media, no rope, no mask."""
    if mixer == CROSS_ATTN:
        return cross_attention(cfg, p, x, media, impl=impl)[0]
    return self_attention(cfg, p, x, mixer=mixer, positions=positions,
                          impl=impl)[0]


def cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    media: torch.Tensor, *, impl: Optional[str] = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A cross-attention layer's output for x (B, S, D) over the normed
    media (B, M, D): q from x, k and v from the media, no rope, no mask.
    Returns (output, k, v); k and v (B, M, K, hd) are the decode cache."""
    q, k, v = _qkv(cfg, p, x, media, x.dtype)
    out = flash_attention(q, k, v, causal=False, softcap=cfg.logit_softcap,
                          impl=impl)
    return _attn_out(p, out, x.dtype), k, v


def _kv_source(cfg: ModelConfig, tp: int) -> list:
    """For each KV head: (the first TP rank that holds it, its index
    among that rank's KV heads)."""
    src = []
    for h in range(cfg.n_kv_heads):
        for r in range(tp):
            lo, n = kv_block(cfg, tp, r)
            if lo <= h < lo + n:
                src.append((r, h - lo))
                break
    return src


def _all_heads(cfg: ModelConfig, q: torch.Tensor, kv: tuple) -> tuple:
    """Every query head of the token (B, 1, H_pad, hd; the padded
    order of ``q_heads`` where the heads do not split) and, given the
    rank's ``kv`` = (k, v) (or ``()``), every KV head's k and v (B, 1,
    K, hd): one gather of the TP ranks' heads (``tp_heads``); as they
    are without TP."""
    ctx = get_ctx()
    tp = tp_size(ctx)
    if tp == 1:
        return (q,) + tuple(kv)
    B, _, Hl, hd = q.shape
    parts = tp_heads(ctx, torch.cat((q,) + tuple(kv), dim=2))
    out = (parts[:, :, :, :Hl].permute(1, 2, 0, 3, 4)
           .reshape(B, 1, tp * Hl, hd),)
    if not kv:
        return out
    Kl = kv[0].shape[2]
    src = _kv_source(cfg, tp)
    return out + tuple(torch.stack([parts[r, :, :, off + i] for r, i in src],
                                   dim=2) for off in (Hl, Hl + Kl))


def attn_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                t: int, *, mixer: str, slot: Optional[int] = None
                ) -> tuple[torch.Tensor, dict]:
    """Single-token decode. x: (B, 1, D). cache: {"k","v"}: (B, S, K, hd).

    ``t`` is the absolute position (rope); ``slot`` is the cache write/read
    index (differs from ``t`` for chunked-local ring-buffer caches).  The
    cache is updated in place (the reference returns a new one), so a
    cache sized at ``max_seq`` is written once per token.  A
    cross-attention layer's cache holds the media's K / V (B, M, K, hd)
    from the prefill: the token's q attends to all of it, and the cache
    is returned unchanged.

    Where the cache is cut on its positions (``runtime.context.
    cache_cut``: n blocks, this rank's block j of S_b positions of every
    KV head) the token's q, k and v heads are gathered over the TP axis
    (``_all_heads``), the rank that holds ``slot`` writes k and v, every
    rank attends over its block (``decode_attention_cut``, a cross layer
    over its block of the media with ``t = M - 1``), and the rank keeps
    its own query heads for its rows of ``wo``.
    """
    dtype = x.dtype
    ctx = get_ctx()
    n, j = cache_cut(ctx)
    Sb = cache["k"].shape[1]
    lo = j * Sb
    if mixer == CROSS_ATTN:
        q, _, _ = _qkv(cfg, p, x, x[:, :1], dtype)       # only q matters
        kv, last = (), n * Sb - 1
    else:
        if slot is None:
            slot = t
        q, k, v = _qkv(cfg, p, x, x, dtype)
        pos = torch.tensor([t], dtype=torch.int32, device=x.device)
        q = rope(q, pos, cfg.rope_theta)
        kv, last = (rope(k, pos, cfg.rope_theta), v), slot
    Hl = q.shape[2]
    if n > 1:
        q, *kv = _all_heads(cfg, q, kv)
    if kv and lo <= slot < lo + Sb:
        cache["k"][:, slot - lo:slot - lo + 1] = kv[0].to(cache["k"].dtype)
        cache["v"][:, slot - lo:slot - lo + 1] = kv[1].to(cache["v"].dtype)
    if n == 1:
        out = decode_attention(q, cache["k"], cache["v"], last,
                               softcap=cfg.logit_softcap)
    else:
        i = tp_index(ctx)
        out = decode_attention_cut(q, cache["k"], cache["v"], last, lo=lo,
                                   softcap=cfg.logit_softcap
                                   )[:, :, i * Hl:(i + 1) * Hl]
    return _attn_out(p, out, dtype), cache


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


def make_mlp_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    std = d ** -0.5

    def normal(shape, s):
        return _normal(gen, shape, s)

    if cfg.mlp_gated:
        return {"w_gate": normal((d, f), std), "w_up": normal((d, f), std),
                "w_down": normal((f, d), f ** -0.5)}
    return {"w_up": normal((d, f), std), "w_down": normal((f, d), f ** -0.5)}


def mlp_forward(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or GELU where the weights have no gate.  The GELU is the
    tanh approximation, ``jax.nn.gelu``'s default.  Under TP the rank's
    columns of ``d_ff``, then its rows of ``w_down``, summed."""
    dtype = x.dtype
    ctx = get_ctx()
    x = tp_enter(ctx, x)
    if "w_gate" in p:
        h = F.silu(x @ _w(p, "w_gate", dtype)) * (x @ _w(p, "w_up", dtype))
    else:
        h = F.gelu(x @ _w(p, "w_up", dtype), approximate="tanh")
    return tp_exit(ctx, h @ _w(p, "w_down", dtype))


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, fixed capacity, EP over an axis)
# ---------------------------------------------------------------------------


def make_moe_params(cfg: ModelConfig, gen: torch.Generator,
                    expert_dtype: torch.dtype = torch.float32) -> dict:
    """The router, the (E, ...) expert stacks and the shared expert.  Each
    expert's matrix is drawn on its own, in float32, and stored in
    ``expert_dtype``: the same numbers at any storage dtype, and one
    expert's float32 draw alive at a time (a llama4-maverick layer's
    stacks are 64 GB in float32)."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.n_experts
    std = d ** -0.5
    dev = _device(gen)

    def normal(shape, s):
        return _normal(gen, shape, s)

    def experts(shape, s):
        out = torch.empty((E, *shape), dtype=expert_dtype, device=dev)
        if dev.type != "meta":
            for e in range(E):
                out[e] = normal(shape, s)
        return out

    p = {"router": normal((d, E), std), "w_gate": experts((d, f), std),
         "w_up": experts((d, f), std), "w_down": experts((f, d), f ** -0.5)}
    if m.d_shared:
        p["shared"] = {"w_gate": normal((d, m.d_shared), std),
                       "w_up": normal((d, m.d_shared), std),
                       "w_down": normal((m.d_shared, d),
                                        m.d_shared ** -0.5)}
    return p


def _router(cfg: ModelConfig, p: dict, xf: torch.Tensor):
    """xf: (T, D) -> top-k expert ids (T, k) int64 and their softmax
    weights (T, k) float32, from float32 logits.  Among equal logits the
    lower id comes first, as ``jax.lax.top_k`` orders them: a stable
    descending sort (``torch.topk`` promises no order among ties)."""
    logits = xf.float() @ p["router"].float()
    w, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    return idx[:, :k], torch.softmax(w[:, :k], dim=-1)


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8


def _expert_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) -> (E, C, D): every slot, empty ones included."""
    dtype = x.dtype
    h = F.silu(torch.bmm(x, _w(p, "w_gate", dtype))) \
        * torch.bmm(x, _w(p, "w_up", dtype))
    return torch.bmm(h, _w(p, "w_down", dtype))


def _dispatch_slots(cfg: ModelConfig, idx: torch.Tensor, T: int):
    """Slot of every (token, choice) pair in a buffer of E * C_e rows: its
    expert's block, at its rank among the pairs routed to that expert in
    the flat token-major order ``idx.reshape(T * k)``.  Pairs ranked at
    C_e or past it are dropped: their slot is E * C_e, the sink row.

    The reference ranks the pairs by a cumsum of their (T*k, E) one-hot
    rows; here a stable sort by expert keeps each expert's pairs in flat
    order, and a pair's rank is its place in the sort less its expert's
    first place (a binary search of the sorted ids): the same ranks,
    without the (T*k, E) scan (on the card that scan took 25 ms a layer
    at qwen3-moe's prefill) and without a read back to the host."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    C_e = _capacity(cfg, T)
    flat_e = idx.reshape(T * k)
    sorted_e, order = torch.sort(flat_e, stable=True)
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(T * k, device=flat_e.device) \
        - torch.searchsorted(sorted_e, sorted_e)
    slot = torch.where(pos < C_e, flat_e * C_e + pos,
                       torch.full_like(pos, E * C_e))
    return slot.reshape(T, k), C_e


def _scatter(xf: torch.Tensor, slot: torch.Tensor, rows: int
             ) -> torch.Tensor:
    """(rows, D) buffer holding each kept pair's token at its slot, zeros
    elsewhere; the dropped pairs land in a sink row past ``rows``, which
    is cut off."""
    buf = xf.new_zeros((rows + 1, xf.shape[1]))
    for j in range(slot.shape[1]):
        buf.index_copy_(0, slot[:, j], xf)
    return buf[:rows]


def _combine(xf: torch.Tensor, ret: torch.Tensor, slot: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """ret: (E*C_e, D) expert outputs; each token's k slots gathered (a
    dropped pair reads the zero sink row) and mixed in float32, j = 0 ..
    k-1 in order."""
    ret = torch.cat([ret, ret.new_zeros((1, ret.shape[1]))])
    out = torch.zeros(xf.shape, dtype=torch.float32, device=xf.device)
    for j in range(slot.shape[1]):
        out = out + w[:, j:j + 1] * ret[slot[:, j]].float()
    return out


def _shared_expert(p: dict, xf: torch.Tensor) -> torch.Tensor:
    sh = p["shared"]
    dt = xf.dtype
    h = F.silu(xf @ _w(sh, "w_gate", dt)) * (xf @ _w(sh, "w_up", dt))
    return (h @ _w(sh, "w_down", dt)).float()


def _finish(cfg: ModelConfig, p: dict, xf: torch.Tensor, out: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """The shared expert added in float32, in the input's shape: under TP
    the rank's partial sums (its slice of ``f_e`` and of the shared
    expert), which ``moe_forward`` sums over the axis in float32."""
    if cfg.moe.d_shared:
        out = out + _shared_expert(p, xf)
    return out.reshape(x.shape)


def _route(cfg: ModelConfig, p: dict, xf: torch.Tensor):
    """(expert ids, weights): the router runs on every TP rank alike, on
    the tokens as they entered (``tp_enter``); its replicated weights
    enter through ``tp_copy``, so their gradient is whole."""
    return _router(cfg, {"router": tp_copy(get_ctx(), p["router"])}, xf)


def moe_local(cfg: ModelConfig, p: dict, x: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Single-device MoE. x: (B, S, D); the output in ``out_dtype``
    (default x's)."""
    E = cfg.moe.n_experts
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    idx, w = _route(cfg, p, xf)
    slot, C_e = _dispatch_slots(cfg, idx, T)
    buf = _scatter(xf, slot, E * C_e)
    yb = _expert_ffn(p, buf.view(E, C_e, D)).reshape(E * C_e, D)
    out = _finish(cfg, p, xf, _combine(xf, yb, slot, w), x)
    return out.to(out_dtype or x.dtype)


def moe_distributed_replicated(cfg: ModelConfig, p: dict, x: torch.Tensor,
                               ctx) -> torch.Tensor:
    """EP with *replicated* tokens (small-batch decode: fewer sequences
    than data-parallel ranks).  Every rank routes all tokens through its
    own experts; one float32 all-reduce over the expert axis combines the
    outputs, with no all_to_all.  Returns the float32 sums."""
    B, S, D = x.shape
    T = B * S
    _, my, n_ep = ep_group(ctx)
    E_loc = p["w_gate"].shape[0]
    E = E_loc * n_ep
    xf = x.reshape(T, D)
    idx, w = _route(cfg, p, xf)
    slot, C_e = _dispatch_slots(cfg, idx, T)
    buf = _scatter(xf, slot, E * C_e)
    rows = slice(my * E_loc * C_e, (my + 1) * E_loc * C_e)
    yout = _expert_ffn(p, buf[rows].view(E_loc, C_e, D))
    full = torch.zeros((E * C_e, D), dtype=torch.float32, device=x.device)
    full[rows] = yout.reshape(E_loc * C_e, D).float()
    full = all_reduce_sum(ctx, full)
    return _finish(cfg, p, xf, _combine(xf, full, slot, w), x)


def moe_distributed(cfg: ModelConfig, p: dict, x: torch.Tensor, ctx
                    ) -> torch.Tensor:
    """Expert-parallel MoE on the tokens x (B_loc, S, D) and the rank's
    own experts (E_loc, ...): one all_to_all ships every top-k choice in a
    single (E * C_e)-row buffer (in ``moe.dispatch_dtype`` where set),
    another brings the expert outputs back in the activation dtype.
    Where the dispatch is ``pooled``, the slots and the capacity are
    those of the pooled ids of the rank's set of blocks (``pool_ids``),
    of which the rank fills its own.  Returns the float32 sums."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    _, _, n_ep = ep_group(ctx)
    E_loc = p["w_gate"].shape[0]
    E = E_loc * n_ep
    xf = x.reshape(T, D)
    idx, w = _route(cfg, p, xf)     # router replicated; runs locally
    if pooled(ctx):
        ids, i = pool_ids(ctx, idx)
        slot, C_e = _dispatch_slots(cfg, ids, ids.shape[0])
        slot = slot[i * T:(i + 1) * T]
    else:
        slot, C_e = _dispatch_slots(cfg, idx, T)
    send = _scatter(xf, slot, E * C_e).view(n_ep, E_loc * C_e, D)
    if m.dispatch_dtype:  # e.g. fp8 dispatch (combine stays in act dtype)
        send = send.to(getattr(torch, m.dispatch_dtype))
    recv = all_to_all(ctx, send).to(xf.dtype)
    # recv: (n_ep, E_loc*C_e, D), every source rank's rows for my experts
    xin = recv.reshape(n_ep, E_loc, C_e, D).transpose(0, 1) \
              .reshape(E_loc, n_ep * C_e, D)
    yout = _expert_ffn(p, xin)
    back = yout.reshape(E_loc, n_ep, C_e, D).transpose(0, 1) \
               .reshape(n_ep, E_loc * C_e, D)
    ret = all_to_all(ctx, back).reshape(E * C_e, D)
    return _finish(cfg, p, xf, _combine(xf, ret, slot, w), x)


def _moe(cfg: ModelConfig, p: dict, x: torch.Tensor, ctx) -> torch.Tensor:
    """``moe_forward``'s float32 partial sums on the entered tokens."""
    n = cfg.moe_seq_chunks
    B, S, D = x.shape
    if n > 1 and S % n == 0:
        sub = dataclasses.replace(cfg, moe_seq_chunks=1)
        ys = [_moe(sub, p, xc, ctx)
              for xc in x.reshape(B, n, S // n, D).unbind(1)]
        return torch.stack(ys, dim=1).reshape(B, S, D)
    if ctx.mesh is None or ctx.ep_axis is None \
            or ctx.mesh.shape[ctx.ep_axis] == 1:
        return moe_local(cfg, p, x, torch.float32)
    dp_div = math.prod(ctx.mesh.shape[a] for a in ctx.dp_axes)
    if not ctx.sharded_batch and (B % dp_div != 0 or B < dp_div):
        return moe_distributed_replicated(cfg, p, x, ctx)
    return moe_distributed(cfg, p, x, ctx)


def moe_forward(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Without an expert axis in the context, ``moe_local``; on one,
    ``moe_distributed``, or ``moe_distributed_replicated`` where a rank
    holds fewer sequences than there are data-parallel ranks (the
    reference's test in its manual step; in the baseline step,
    ``ctx.sharded_batch``, the reference tests the global batch, which
    always splits).  In the baseline step on a mesh with dp ranks off the
    expert axis (``"pod"``), the dispatch ranks the pairs of the rank's
    set of blocks, pooled over the ranks that hold it
    (``runtime.context.pool_ids``: the rows the reference's ``shard_map``,
    manual over ``"data"`` alone, dispatches together), with the capacity
    of those tokens, and each rank dispatches its own rows; the secure
    step's dispatch ranks each rank's rows alone, as the reference's
    manual step does.  ``cfg.moe_seq_chunks > 1`` splits the
    dispatch over sequence chunks, each with the capacity of its own
    tokens.  The tokens enter through ``tp_enter`` and the partial sums
    leave through ``tp_exit`` in float32, then take x's dtype."""
    ctx = get_ctx()
    return tp_exit(ctx, _moe(cfg, p, tp_enter(ctx, x), ctx)).to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 (SSD) mixer
# ---------------------------------------------------------------------------


def make_mamba_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Projections split per component (z | x | B | C | dt), as the
    reference keeps them."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    std = d ** -0.5
    dev = _device(gen)

    def normal(shape, sd):
        return _normal(gen, shape, sd)

    def zeros(n):
        return torch.zeros((n,), device=dev)

    return {
        "in_z": normal((d, d_in), std), "in_x": normal((d, d_in), std),
        "in_B": normal((d, s.d_state), std),
        "in_C": normal((d, s.d_state), std), "in_dt": normal((d, nh), std),
        "conv_x": normal((s.d_conv, d_in), 0.1), "conv_xb": zeros(d_in),
        "conv_B": normal((s.d_conv, s.d_state), 0.1),
        "conv_Bb": zeros(s.d_state),
        "conv_C": normal((s.d_conv, s.d_state), 0.1),
        "conv_Cb": zeros(s.d_state),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "D": torch.ones((nh,), device=dev), "dt_bias": zeros(nh),
        "out_norm": torch.ones((d_in,), device=dev),
        "out_proj": normal((d_in, d), d_in ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """x: (B, S, C); w: (K, C) depthwise causal conv. Returns y, new_state."""
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[-1]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K)) + b
    # a copy, not a view: a cached view would keep all of xp alive
    new_state = xp[:, -(K - 1):].clone() if K > 1 else torch.zeros_like(pad)
    return F.silu(y), new_state


def mamba_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  state: Optional[dict] = None, decode: bool = False,
                  impl: Optional[str] = None):
    """Mamba2 block. x: (B, S, D). state (decode, or a prefill that goes
    on from an earlier one): {"conv_x": (B,K-1,d_in), "conv_B"/"conv_C":
    (B,K-1,N), "ssd": (B,H,P,N)}; returns (y, state).  The prefill's scan
    goes through the ``ssd_chunked`` kernel wrapper, from ``state["ssd"]``
    or a zero state, and is differentiable (its backward a kernel on the
    card); decode is the one-step recurrence in plain torch."""
    s = cfg.ssm
    ctx = get_ctx()
    dtype = x.dtype
    # the rank's SSD heads [h0, h0 + nh) and their d_in_loc channels; the
    # replicated weights enter through tp_copy (their gradient whole)
    d_in_loc = p["in_x"].shape[1]
    nh = d_in_loc // s.head_dim
    h0 = nh * tp_index(ctx)
    xt = tp_enter(ctx, x)
    Bsz, S, D = xt.shape
    d_in = s.expand * D

    def rep(name):
        return tp_copy(ctx, _w(p, name, dtype))

    z = xt @ _w(p, "in_z", dtype)
    xr = xt @ _w(p, "in_x", dtype)
    Br = xt @ rep("in_B")
    Cr = xt @ rep("in_C")
    dtr = xt @ rep("in_dt")[:, h0:h0 + nh]

    st = state or {}
    xr, new_cx = _causal_conv(xr, _w(p, "conv_x", dtype),
                              _w(p, "conv_xb", dtype), st.get("conv_x"))
    Bm, new_cb = _causal_conv(Br, rep("conv_B"), rep("conv_Bb"),
                              st.get("conv_B"))
    Cm, new_cc = _causal_conv(Cr, rep("conv_C"), rep("conv_Cb"),
                              st.get("conv_C"))
    xs = xr.reshape(Bsz, S, nh, s.head_dim)

    def mine(name):
        return tp_copy(ctx, p[name])[h0:h0 + nh]

    dt = F.softplus(dtr.float() + mine("dt_bias"))                 # (B,S,H)
    A = -torch.exp(mine("A_log"))                                   # (H,)

    if decode:
        # recurrent single-step update (S == 1)
        st = state["ssd"]
        dA = torch.exp(dt[:, 0] * A[None, :])                       # (B,H)
        dBx = torch.einsum("bn,bhp,bh->bhpn", Bm[:, 0].float(),
                           xs[:, 0].float(), dt[:, 0])
        st = st * dA[..., None, None] + dBx
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), st)
        y = y[:, None].to(dtype)                                    # (B,1,H,P)
        new_ssd = st
    else:
        init = None if state is None else state["ssd"]
        y, new_ssd = ssd_chunked(xs.float().contiguous(), dt,
                                 A, Bm.float().contiguous(),
                                 Cm.float().contiguous(), min(s.chunk, S),
                                 init, impl=impl)
        y = y.to(dtype)

    y = y + xs * mine("D").to(dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, d_in_loc)
    # gated RMSNorm (mamba2 style), its mean over the whole d_in: under
    # TP the ranks' sums of squares summed (and its gradient back to
    # every rank's channels)
    y = y * F.silu(z)
    yf = y.float()
    if tp_size(ctx) == 1:
        ms = torch.mean(yf * yf, -1, keepdim=True)
    else:
        ms = tp_copy(ctx, tp_reduce(ctx, torch.sum(
            yf * yf, -1, keepdim=True))) / d_in
    y = (yf * torch.rsqrt(ms + 1e-6) * p["out_norm"]).to(dtype)
    out = tp_exit(ctx, y @ _w(p, "out_proj", dtype))
    new_state = {"conv_x": new_cx.to(dtype), "conv_B": new_cb.to(dtype),
                 "conv_C": new_cc.to(dtype), "ssd": new_ssd}
    return out, new_state

