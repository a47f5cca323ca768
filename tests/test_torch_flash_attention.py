"""The port's flash attention (its plain version, which a CPU tensor runs)
against the JAX package.

The same inputs, drawn from a seeded numpy generator, go through the
Pallas kernel in interpret mode (``flash_attention_op``, as
``tests/test_kernels.py`` runs it) and through the port's
``flash_attention`` on CPU tensors, at the five shapes of
``tests/test_kernels.py`` and with its tolerances: 2e-6 in float32, 2e-2
in bfloat16 (one bf16 rounding of outputs computed in float32); then at
the shapes the frontend models bring (``FRONTEND_SHAPES``): head dim 80,
hubert-xlarge's, causal and bidirectional, and a cross-attention's
non-causal Sq != Skv under GQA 4, as llama-3.2-vision's 2,048 queries
attend to 4,096 media tokens.  At the
ragged lengths the Pallas kernel refuses (it asserts Sq % bq == 0) the
port is held against ``attention_ref`` and the model's jnp
``layers.flash_attention``.  The CUDA kernel is held against the same
plain version on the card by ``chip_smoke.py``.  The bf16 kernel's own
numerics on the tensor cores are emulated here in plain torch
(``tensor_core_numerics``) and held to the same bf16 tolerance.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref, flash_attention_op
from repro.models.layers import flash_attention as jnp_flash
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask

SHAPES = [
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 128, 2, 2, 32, False, 0),
    (1, 512, 512, 4, 1, 64, True, 128),
    (2, 128, 384, 2, 1, 32, True, 0),
    (1, 256, 256, 8, 8, 16, True, 0),
]
FRONTEND_SHAPES = [
    (2, 128, 128, 4, 4, 80, True, 0),
    (2, 128, 128, 4, 2, 80, False, 0),
    (1, 64, 128, 8, 2, 32, False, 0),
]


def _inputs(seed, B, Sq, Skv, H, K, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, K, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, K, hd)).astype(np.float32))


def _port(arrays, dtype, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    return flash_attention(q, k, v, **kw).float().numpy()


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window",
                         SHAPES + FRONTEND_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(B, Sq, Skv, H, K, hd, causal, window,
                                     dtype):
    arrays = _inputs(Sq + H, B, Sq, Skv, H, K, hd)
    jq, jk, jv = (jnp.asarray(a, dtype=dtype) for a in arrays)
    want = np.asarray(flash_attention_op(jq, jk, jv, causal=causal,
                                         window=window, interpret=True),
                      np.float32)
    got = _port(arrays, getattr(torch, dtype), causal=causal, window=window)
    tol = 2e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("Sq,causal,window", [(77, True, 0), (200, True, 0),
                                              (77, True, 32),
                                              (200, False, 64)])
def test_ragged_lengths_match_oracles(Sq, causal, window):
    """Lengths that no tile divides: the kernel masks the ragged edge
    itself, the plain version has none."""
    arrays = _inputs(Sq, 2, Sq, Sq, 4, 2, 32)
    got = _port(arrays, torch.float32, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    want = attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-6, rtol=2e-6)
    model = jnp_flash(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(model), atol=2e-6, rtol=2e-6)


def test_query_with_no_allowed_key_is_the_mean_of_v():
    """A window chunk past the keys (Sq > Skv) leaves a row with no
    allowed key: every score is -1e30 and the row is the uniform average
    of v, as in the reference, never NaN."""
    arrays = _inputs(3, 1, 96, 40, 2, 2, 16)
    got = _port(arrays, torch.float32, causal=True, window=32)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    want = np.asarray(attention_ref(jq, jk, jv, causal=True, window=32))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(got[0, 64:], np.broadcast_to(
        arrays[2].mean(axis=1)[0], (32, 2, 16)), atol=1e-6)


def test_cuda_wrapper_refuses_what_it_cannot_take():
    """Nothing falls back: ``impl="cuda"`` needs CUDA tensors, and the
    launcher's own refusals raise ``ValueError``."""
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fa_ops.flash_attention_cuda(q, q, q, True, 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_ops.flash_attention_cuda(q.half(), q.half(), q.half(), True, 0)
    for rc in fa_ops._REFUSED:
        with pytest.raises(ValueError, match=f"status {rc}"):
            backend.raise_on(rc, "flash_attention", fa_ops._REFUSED)
    assert backend.FLASH_ATTENTION.launches == 0


def tensor_core_numerics(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int,
                         tile: int = 64) -> torch.Tensor:
    """A plain-torch emulation of the bf16 tensor-core kernel's numerics:
    per 64-key tile, S = q k^T from bf16 operands summed in float32, the
    scale 1/sqrt(hd) applied to S in float32 after the product, masked
    scores -1e30 (keys past Skv never enter), the online softmax in
    float32 with l summed from the unrounded p, and P rounded to bf16
    before O += P v (float32 sums); l clamped at 1e-30, the output
    rounded to bf16.  q, k, v bf16 in the public layout."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, Sq, hd)
    kf = k.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    allowed = attention_mask(Sq, Skv, causal, window, "cpu")
    m = torch.full((B, H, Sq, 1), NEG_INF)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, hd))
    for k0 in range(0, Skv, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = (qf @ kt.transpose(-1, -2)) * scale
        s = s.masked_fill(~allowed[:, k0:k0 + tile], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vt
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window",
                         SHAPES + FRONTEND_SHAPES)
def test_tensor_core_numerics_hold_the_bf16_tolerance(B, Sq, Skv, H, K, hd,
                                                      causal, window):
    """Why 2e-2 still holds for the bf16 kernel on the tensor cores: its
    numerics (scale after the bf16 product, P rounded to bf16 before P v)
    against the Pallas kernel in interpret mode and the reference's
    ``attention_ref``, in bf16, at ``tests/test_kernels.py``'s shapes."""
    arrays = _inputs(Sq + H, B, Sq, Skv, H, K, hd)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = tensor_core_numerics(q, k, v, causal, window).float().numpy()
    jq, jk, jv = (jnp.asarray(a, dtype="bfloat16") for a in arrays)
    pallas = np.asarray(flash_attention_op(jq, jk, jv, causal=causal,
                                           window=window, interpret=True),
                        np.float32)
    np.testing.assert_allclose(got, pallas, atol=2e-2, rtol=2e-2)
    ref = np.asarray(attention_ref(jq, jk, jv, causal=causal, window=window),
                     np.float32)
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("Sq,Skv,causal,window", [(77, 77, True, 0),
                                                  (200, 77, True, 64),
                                                  (96, 40, True, 32)])
def test_tensor_core_numerics_at_ragged_lengths(Sq, Skv, causal, window):
    """Ragged tiles and rows with no allowed key (a window chunk past the
    keys), against ``attention_ref`` in bf16."""
    arrays = _inputs(Sq + Skv, 2, Sq, Skv, 4, 2, 32)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = tensor_core_numerics(q, k, v, causal, window).float().numpy()
    jq, jk, jv = (jnp.asarray(a, dtype="bfloat16") for a in arrays)
    ref = np.asarray(attention_ref(jq, jk, jv, causal=causal, window=window),
                     np.float32)
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


def test_backward_refuses_head_dim_80_with_its_own_message():
    """The backward takes hd 80 as the forward does, and its refusal of a
    head dim names every instantiation, 80 among them."""
    assert 80 in fa_ops.HEAD_DIMS and 80 in fa_ops.BWD_HEAD_DIMS
    assert fa_ops.BWD_HEAD_DIMS == (16, 32, 64, 80, 128)
    with pytest.raises(ValueError, match=r"backward kernel's instantiations "
                                         r"\(16, 32, 64, 80, 128\)"):
        backend.raise_on(1001, "flash_attention_bwd", fa_ops._REFUSED_BWD)
    with pytest.raises(ValueError, match=r"\(16, 32, 64, 80, 128\)"):
        backend.raise_on(1001, "flash_attention", fa_ops._REFUSED)
