"""Model layer primitives of the port: norms, rotary, GQA attention (full
and chunked-window), the dense MLP, the Mamba2 SSD mixer.

Counterpart of ``repro/models/layers.py``, for what the dense models
and mamba2-370m use.  Functions are plain functions of tensors and parameter
dicts, with the reference's weight layout (``x @ W``, W of shape
``(in, out)``), so carrying weights across is a copy.  Every prefill goes
through a kernel wrapper: attention through ``flash_attention``, the SSD
scan through ``ssd_chunked``; each launches its CUDA kernel on a CUDA
tensor and runs its plain version on a CPU tensor (or under
``impl="torch"``).  Decode stays plain torch, as it is plain jnp in the
reference.  The reference's ``constrain`` (sharding hints) has no
counterpart on one device and is left out.

Not ported yet, each raising with the slice it waits for (see
``model.check_supported``): the MoE MLP and the cross-attention media
path.  Logit soft-capping runs in decode only: a prefill with it raises,
as the reference's does.
Training differentiates through everything here with autograd;
attention's and the SSD scan's backwards are their wrappers' own (CUDA
kernels on the card).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ATTN_CHUNKED, CROSS_ATTN, ModelConfig
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.ssd import ssd_chunked

NEG_INF = -1e30


def not_ported(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"the {slice_} slice")


def _w(p: dict, name: str, dtype: torch.dtype) -> torch.Tensor:
    """A parameter in the compute dtype (a no-op when it already is)."""
    return p[name].to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def make_norm_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    if cfg.norm == "nonparam_ln":
        return {}
    return {"scale": torch.ones((cfg.d_model,), dtype=torch.float32,
                                device=gen.device)}


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
    _, S, K, _ = k_cache.shape
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qg = (q[:, 0] * scale).reshape(B, K, G, hd)
    valid = torch.arange(S, device=q.device) <= t
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float())
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def make_attn_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, hd, H, K = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    std = d ** -0.5
    dev = gen.device

    def normal(shape, s):
        return torch.randn(shape, generator=gen, device=dev) * s

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
    B, Sq, _ = x.shape
    Skv = kv_src.shape[1]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ _w(p, "wq", dtype)
    k = kv_src @ _w(p, "wk", dtype)
    v = kv_src @ _w(p, "wv", dtype)
    if cfg.attn_bias:
        q = q + _w(p, "bq", dtype)
        k = k + _w(p, "bk", dtype)
        v = v + _w(p, "bv", dtype)
    q = q.reshape(B, Sq, H, hd)
    k = k.reshape(B, Skv, K, hd)
    v = v.reshape(B, Skv, K, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    return q, k, v


def attn_forward(cfg: ModelConfig, p: dict, x: torch.Tensor, *, mixer: str,
                 positions: Optional[torch.Tensor] = None,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill). x: (B, S, D)."""
    if mixer == CROSS_ATTN:
        raise not_ported("cross-attention", "cross-attention and frontends")
    dtype = x.dtype
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, x, dtype)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.attn_window if mixer == ATTN_CHUNKED else 0
    out = flash_attention(q, k, v, causal=cfg.causal, window=window,
                          softcap=cfg.logit_softcap, impl=impl)
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ _w(p, "wo", dtype)


def attn_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                t: int, *, mixer: str, slot: Optional[int] = None
                ) -> tuple[torch.Tensor, dict]:
    """Single-token decode. x: (B, 1, D). cache: {"k","v"}: (B, S, K, hd).

    ``t`` is the absolute position (rope); ``slot`` is the cache write/read
    index (differs from ``t`` for chunked-local ring-buffer caches).  The
    cache is updated in place (the reference returns a new one), so a
    cache sized at ``max_seq`` is written once per token.
    """
    if mixer == CROSS_ATTN:
        raise not_ported("cross-attention", "cross-attention and frontends")
    dtype = x.dtype
    B = x.shape[0]
    if slot is None:
        slot = t
    q, k, v = _qkv(cfg, p, x, x, dtype)
    pos = torch.tensor([t], dtype=torch.int32, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    cache["k"][:, slot:slot + 1] = k.to(cache["k"].dtype)
    cache["v"][:, slot:slot + 1] = v.to(cache["v"].dtype)
    out = decode_attention(q, cache["k"], cache["v"], slot,
                           softcap=cfg.logit_softcap)
    y = out.reshape(B, 1, cfg.n_heads * cfg.hd) @ _w(p, "wo", dtype)
    return y, cache


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


def make_mlp_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    std = d ** -0.5
    dev = gen.device

    def normal(shape, s):
        return torch.randn(shape, generator=gen, device=dev) * s

    if cfg.mlp_gated:
        return {"w_gate": normal((d, f), std), "w_up": normal((d, f), std),
                "w_down": normal((f, d), f ** -0.5)}
    return {"w_up": normal((d, f), std), "w_down": normal((f, d), f ** -0.5)}


def mlp_forward(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or GELU where the weights have no gate.  The GELU is the
    tanh approximation, ``jax.nn.gelu``'s default."""
    dtype = x.dtype
    if "w_gate" in p:
        h = F.silu(x @ _w(p, "w_gate", dtype)) * (x @ _w(p, "w_up", dtype))
    else:
        h = F.gelu(x @ _w(p, "w_up", dtype), approximate="tanh")
    return h @ _w(p, "w_down", dtype)


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
    dev = gen.device

    def normal(shape, sd):
        return torch.randn(shape, generator=gen, device=dev) * sd

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
    dtype = x.dtype
    Bsz, S, D = x.shape
    d_in = s.expand * D
    nh = d_in // s.head_dim
    z = x @ _w(p, "in_z", dtype)
    xr = x @ _w(p, "in_x", dtype)
    Br = x @ _w(p, "in_B", dtype)
    Cr = x @ _w(p, "in_C", dtype)
    dtr = x @ _w(p, "in_dt", dtype)

    st = state or {}
    xr, new_cx = _causal_conv(xr, _w(p, "conv_x", dtype),
                              _w(p, "conv_xb", dtype), st.get("conv_x"))
    Bm, new_cb = _causal_conv(Br, _w(p, "conv_B", dtype),
                              _w(p, "conv_Bb", dtype), st.get("conv_B"))
    Cm, new_cc = _causal_conv(Cr, _w(p, "conv_C", dtype),
                              _w(p, "conv_Cb", dtype), st.get("conv_C"))
    xs = xr.reshape(Bsz, S, nh, s.head_dim)

    dt = F.softplus(dtr.float() + p["dt_bias"])                    # (B,S,H)
    A = -torch.exp(p["A_log"])                                      # (H,)

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

    y = y + xs * _w(p, "D", dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, d_in)
    # gated RMSNorm (mamba2 style)
    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
         * p["out_norm"]).to(dtype)
    out = y @ _w(p, "out_proj", dtype)
    new_state = {"conv_x": new_cx.to(dtype), "conv_B": new_cb.to(dtype),
                 "conv_C": new_cc.to(dtype), "ssd": new_ssd}
    return out, new_state

