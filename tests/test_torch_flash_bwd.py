"""The port's flash attention backward (its plain version, which a CPU
tensor runs) against the JAX package.

The same inputs, drawn from a seeded numpy generator, go through
``jax.vjp`` of the reference's training attention
(``repro.models.layers.flash_attention``: chunked jnp with the
FlashAttention-2 custom VJP) and through torch autograd of the port's
``flash_attention`` on CPU tensors (its ``torch.autograd.Function``:
``attention_fwd_ref`` forward, ``attention_bwd_ref`` backward), over GQA
groups 1, 2 and 4, causal on and off, a chunked window, ragged lengths
and Sq != Skv, in float32 and bfloat16, at ``tests/test_kernels.py``'s
tolerances: 2e-6 in float32, 2e-2 in bfloat16 (the reference rounds the
scaled q to bf16 before its products, the port scales in float32 inside,
as the kernels do; one bf16 rounding of outputs computed in float32).
The CUDA backward kernel is held against the same plain version on the
card by ``chip_smoke.py`` (``_check_flash_bwd``).
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

# (B, Sq, Skv, H, K, hd, causal, window)
SHAPES = [
    (2, 64, 64, 4, 4, 16, True, 0),        # G = 1
    (1, 77, 77, 4, 2, 32, True, 0),        # G = 2, ragged
    (2, 48, 48, 8, 2, 16, False, 0),       # G = 4, not causal
    (1, 96, 96, 4, 1, 16, True, 32),       # G = 4, chunked window
    (1, 40, 72, 4, 2, 16, False, 0),       # Sq != Skv
]


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
