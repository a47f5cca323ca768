"""The port's flash attention (its plain version, which a CPU tensor runs)
against the JAX package.

The same inputs, drawn from a seeded numpy generator, go through the
Pallas kernel in interpret mode (``flash_attention_op``, as
``tests/test_kernels.py`` runs it) and through the port's
``flash_attention`` on CPU tensors, at the five shapes of
``tests/test_kernels.py`` and with its tolerances: 2e-6 in float32, 2e-2
in bfloat16 (one bf16 rounding of outputs computed in float32).  At the
ragged lengths the Pallas kernel refuses (it asserts Sq % bq == 0) the
port is held against ``attention_ref`` and the model's jnp
``layers.flash_attention``.  The CUDA kernel is held against the same
plain version on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref, flash_attention_op
from repro.models.layers import flash_attention as jnp_flash
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fa_ops

SHAPES = [
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 128, 2, 2, 32, False, 0),
    (1, 512, 512, 4, 1, 64, True, 128),
    (2, 128, 384, 2, 1, 32, True, 0),
    (1, 256, 256, 8, 8, 16, True, 0),
]


def _inputs(seed, B, Sq, Skv, H, K, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, K, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, K, hd)).astype(np.float32))


def _port(arrays, dtype, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    return flash_attention(q, k, v, **kw).float().numpy()


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window", SHAPES)
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
