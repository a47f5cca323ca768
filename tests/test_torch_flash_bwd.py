"""The port's flash attention backward (its plain version, which a CPU
tensor runs) against the JAX package.

The same inputs, drawn from a seeded numpy generator, go through
``jax.vjp`` of the reference's training attention
(``repro.models.layers.flash_attention``: chunked jnp with the
FlashAttention-2 custom VJP) and through torch autograd of the port's
``flash_attention`` on CPU tensors (its ``torch.autograd.Function``:
``attention_fwd_ref`` forward, ``attention_bwd_ref`` backward), over GQA
groups 1, 2 and 4, causal on and off, a chunked window, ragged lengths
and Sq != Skv, head dims 16, 32 and 80 (hubert-xlarge's, causal and with
Sq != Skv), in float32 and bfloat16, at ``tests/test_kernels.py``'s
tolerances: 2e-6 in float32, 2e-2 in bfloat16 (the reference rounds the
scaled q to bf16 before its products, the port scales in float32 inside,
as the kernels do; one bf16 rounding of outputs computed in float32).
The CUDA backward kernel is held against the same plain version on the
card by ``chip_smoke.py`` (``_check_flash_bwd``).

The bf16 kernel's arithmetic is emulated here in plain torch
(``_kernel_bwd``): S and dP from bf16 operands in float32, the scale
1/sqrt(hd) applied after the products, delta from bf16 O, and P and dS
entering their products as bf16 pairs hi + lo.  The emulation is held
against ``attention_bwd_ref`` at the card's gate (``chip_smoke.py``
``FLASH_BWD_TOL[torch.bfloat16]``) and against ``jax.vjp`` of the
reference; one bf16 rounding of P and dS instead misses the gate.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import _flash_fwd_impl
from repro.models.layers import flash_attention as jnp_flash
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_fwd_ref,
                                                 attention_ref,
                                                 flash_attention)
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask

# (B, Sq, Skv, H, K, hd, causal, window)
SHAPES = [
    (2, 64, 64, 4, 4, 16, True, 0),        # G = 1
    (1, 77, 77, 4, 2, 32, True, 0),        # G = 2, ragged
    (2, 48, 48, 8, 2, 16, False, 0),       # G = 4, not causal
    (1, 96, 96, 4, 1, 16, True, 32),       # G = 4, chunked window
    (1, 40, 72, 4, 2, 16, False, 0),       # Sq != Skv
    (1, 64, 64, 2, 2, 80, True, 0),        # hd 80 (hubert-xlarge's)
    (1, 40, 72, 4, 2, 80, False, 0),       # hd 80, Sq != Skv
]

# the kernel's cases at hd 64 and 128: chip_smoke.py's ragged windowed
# FLASH_BWD_CASES entry (Sq != Skv, rows with no allowed key), and qwen3's
# heads (GQA 2, hd 128, causal) at Sq = Skv = 512
KERNEL_CASES = [
    (2, 200, 77, 4, 2, 64, True, 64),
    (1, 512, 512, 16, 8, 128, True, 0),
]
# chip_smoke.py's FLASH_BWD_TOL[torch.bfloat16]: (atol, atol as a share of
# the output's largest |entry|, rtol), two bf16 ulps over 2^-10 of it
GATE_BF16 = (0.0, 2 ** -10, 2 ** -6)


def _inputs(seed, B, Sq, Skv, H, K, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, K, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, K, hd)).astype(np.float32),
            rng.normal(size=(B, Sq, H, hd)).astype(np.float32))


def _jax_grads(arrays, dtype, causal, window):
    q, k, v, do = (jnp.asarray(a, dtype=dtype) for a in arrays)
    out, vjp = jax.vjp(lambda a, b, c: jnp_flash(a, b, c, causal=causal,
                                                 window=window), q, k, v)
    return [np.asarray(t, np.float32) for t in (out, *vjp(do))]


def _port_grads(arrays, dtype, causal, window):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = flash_attention(q, k, v, causal=causal, window=window)
    grads = torch.autograd.grad(out, (q, k, v), do)
    return [t.detach().float().numpy() for t in (out, *grads)]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_reference_vjp(B, Sq, Skv, H, K, hd, causal,
                                        window, dtype):
    arrays = _inputs(Sq * 7 + H, B, Sq, Skv, H, K, hd)
    want = _jax_grads(arrays, dtype, causal, window)
    got = _port_grads(arrays, getattr(torch, dtype), causal, window)
    tol = 2e-6 if dtype == "float32" else 2e-2
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window", SHAPES)
def test_saved_lse_matches_reference(B, Sq, Skv, H, K, hd, causal, window):
    """L = m + log(l), the residual both backwards read, in float32."""
    q, k, v, _ = _inputs(Sq + 3 * H, B, Sq, Skv, H, K, hd)
    G = H // K
    qg = (jnp.asarray(q) / math.sqrt(hd)).reshape(B, Sq, K, G, hd) \
        .transpose(0, 2, 3, 1, 4)
    _, L = _flash_fwd_impl(qg, jnp.asarray(k).transpose(0, 2, 1, 3),
                           jnp.asarray(v).transpose(0, 2, 1, 3),
                           causal=causal, window=window, q_offset=0,
                           bq=Sq, bkv=Skv)
    want = np.asarray(L).reshape(B, H, Sq)
    _, got = attention_fwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window", SHAPES)
def test_plain_backward_matches_autograd_of_attention_ref(
        B, Sq, Skv, H, K, hd, causal, window):
    """The FA-2 formulas (delta, P = exp(S - L), dS = P (dP - delta), the
    scale carried to the unscaled q, dK / dV summed over each group)
    equal torch autograd of the full-matrix oracle (both in float32, to
    float32 rounding: 2e-6)."""
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(Sq + H, B, Sq, Skv, H, K, hd))
    o, L = attention_fwd_ref(q, k, v, causal=causal, window=window)
    got = attention_bwd_ref(q, k, v, o, do, L, causal=causal, window=window)
    for t in (q, k, v):
        t.requires_grad_(True)
    want = torch.autograd.grad(
        attention_ref(q, k, v, causal=causal, window=window), (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-6, rtol=2e-6)


def test_grad_off_runs_the_inference_path():
    """Without grad the wrapper returns the plain forward and counts no
    launch; with grad a CPU tensor runs the plain forward and backward
    and still counts none."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(0, 1, 32, 32, 2, 1,
                                                          16))
    backend.reset_launch_counts()
    plain = flash_attention(q, k, v, causal=True)
    q.requires_grad_(True)
    out = flash_attention(q, k, v, causal=True)
    out.backward(do)
    assert torch.equal(out.detach(), plain)
    assert q.grad is not None and q.grad.shape == q.shape
    assert backend.FLASH_ATTENTION.launches == 0
    assert backend.FLASH_ATTENTION_BWD.launches == 0


def test_cuda_path_needs_a_cuda_tensor():
    """``impl="cuda"`` on a CPU tensor raises in the forward: nothing
    falls back to the plain version."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 1, 16, 16, 2, 1,
                                                         16))
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA kernels need CUDA tensors"):
        flash_attention(q, k, v, causal=True, impl="cuda")


def _kernel_bwd(q, k, v, o, do, L, causal, window, split=True):
    """The bf16 backward kernel's arithmetic (``flash_attention_bwd.cu``)
    in plain torch: S = q K^T and dP = dO V^T of bf16 values in float32,
    S scaled after its product, P = exp(S - L) under the -1e30 mask,
    delta from bf16 O, dS = P (dP - delta); P and dS enter dV = P^T dO,
    dK = dS^T q and dQ = dS K as bf16 pairs hi = bf16(x), lo = bf16(x -
    hi) (``split``) or rounded once to bf16; dK and dQ scaled once after
    their products; each output rounded once to bf16."""
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qf, dof = q.float(), do.float()
    kk = k.float().repeat_interleave(G, dim=2)
    vv = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kk) * scale
    s = s.masked_fill(~attention_mask(Sq, Skv, causal, window, q.device),
                      NEG_INF)
    p = torch.exp(s - L[..., None])
    delta = (dof * o.float()).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vv) - delta[..., None])

    def parts(x):
        hi = x.to(torch.bfloat16).float()
        return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)

    dv = sum(torch.einsum("bhqk,bqhd->bkhd", t, dof) for t in parts(p))
    dk = sum(torch.einsum("bhqk,bqhd->bkhd", t, qf) for t in parts(ds))
    dq = sum(torch.einsum("bhqk,bkhd->bqhd", t, kk) for t in parts(ds))

    def by_kv_head(t):
        return t.reshape(B, Skv, K, G, hd).sum(3)

    return ((dq * scale).to(torch.bfloat16),
            by_kv_head(dk * scale).to(torch.bfloat16),
            by_kv_head(dv).to(torch.bfloat16))


def _bf16_case(seed, B, Sq, Skv, H, K, hd, causal, window):
    """bf16 q, k, v, dO from the seed, the plain forward's o and L, and
    the plain backward (the card's reference) on them."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(seed, B, Sq, Skv, H, K, hd))
    o, L = attention_fwd_ref(q, k, v, causal=causal, window=window)
    want = attention_bwd_ref(q, k, v, o, do, L, causal=causal, window=window)
    return (q, k, v, o, do, L), want


def _gate_share(got, want):
    """The largest |got - want| as a share of the gate's limit there."""
    atol, share, rtol = GATE_BF16
    g, w = got.double(), want.double()
    limit = atol + share * w.abs().max() + rtol * w.abs()
    return float(((g - w).abs() / limit).max())


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window",
                         SHAPES + KERNEL_CASES)
def test_kernel_arithmetic_within_the_gate(B, Sq, Skv, H, K, hd, causal,
                                           window):
    """The bf16 kernel's arithmetic (P and dS as bf16 pairs) stays within
    the card's bf16 gate of ``attention_bwd_ref``, in every output."""
    args, want = _bf16_case(Sq + 5 * H, B, Sq, Skv, H, K, hd, causal,
                            window)
    got = _kernel_bwd(*args, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == torch.bfloat16
        assert _gate_share(g, w) <= 1.0, name


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window",
                         SHAPES + KERNEL_CASES)
def test_kernel_arithmetic_matches_reference_vjp(B, Sq, Skv, H, K, hd,
                                                 causal, window):
    """The emulated kernel against ``jax.vjp`` of the reference's training
    attention in bf16, at the file's bf16 tolerance (2e-2)."""
    arrays = _inputs(Sq * 7 + H, B, Sq, Skv, H, K, hd)
    want = _jax_grads(arrays, "bfloat16", causal, window)[1:]
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    o, L = attention_fwd_ref(q, k, v, causal=causal, window=window)
    got = _kernel_bwd(q, k, v, o, do, L, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.float().numpy(), w, atol=2e-2,
                                   rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window", KERNEL_CASES)
def test_one_bf16_rounding_of_p_and_ds_leaves_the_gate(B, Sq, Skv, H, K, hd,
                                                       causal, window):
    """Why the kernel splits P and dS: rounded once to bf16 (as FA-2,
    FA-3 and SDPA do) they take some output past the gate on the same
    inputs on which the split stays under half of it."""
    args, want = _bf16_case(Sq + 5 * H, B, Sq, Skv, H, K, hd, causal,
                            window)
    once = max(_gate_share(g, w) for g, w in
               zip(_kernel_bwd(*args, causal, window, split=False), want))
    split = max(_gate_share(g, w) for g, w in
                zip(_kernel_bwd(*args, causal, window), want))
    assert once > 1.0 and split < 0.5, (once, split)
