"""The port's SSD scan (its plain versions, which a CPU tensor runs)
against the JAX package.

The same inputs, drawn from a seeded numpy generator, go through the
Pallas kernel in interpret mode (``ssd_op``, as ``tests/test_kernels.py``
runs it), the sequential oracle ``ssd_ref`` and the model's
``layers.ssd_chunked``, and through the port's ``ssd`` / ``ssd_ref`` /
``ssd_chunked`` on CPU tensors, at the four shapes of
``tests/test_kernels.py`` with its tolerances (atol 5e-4, rtol 1e-3: the
chunked and sequential forms sum in different orders, in float32).  The
CUDA kernel is held against the same plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_op
from repro.kernels.ssd import ssd_ref as j_ssd_ref
from repro.models.layers import ssd_chunked as j_ssd_chunked
from repro_torch.kernels import backend
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd, ssd_chunked, ssd_ref

TOL = dict(atol=5e-4, rtol=1e-3)


def _per_head(seed, BH, S, P, N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(BH, S, P)).astype(np.float32),
            (np.abs(rng.normal(size=(BH, S))) * 0.1).astype(np.float32),
            -np.abs(rng.normal(size=(BH,))).astype(np.float32),
            rng.normal(size=(BH, S, N)).astype(np.float32),
            rng.normal(size=(BH, S, N)).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (4, 256, 64, 32, 64), (2, 128, 32, 16, 128), (8, 512, 64, 64, 128),
    (1, 64, 16, 8, 32),
])
def test_plain_matches_pallas_kernel_and_oracle(BH, S, P, N, chunk):
    arrays = _per_head(BH * S, BH, S, P, N)
    y, st = ssd(*_t(arrays), chunk=chunk)
    jy, jst = ssd_op(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    ry, rst = ssd_ref(*_t(arrays))
    jry, jrst = j_ssd_ref(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(ry.numpy(), np.asarray(jry), **TOL)
    np.testing.assert_allclose(rst.numpy(), np.asarray(jrst), **TOL)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), **TOL)


@pytest.mark.parametrize("Bsz,S,H,P,N,chunk", [
    (2, 64, 4, 16, 32, 32), (2, 77, 4, 16, 32, 32), (1, 200, 2, 32, 16, 64),
    (3, 24, 8, 16, 32, 32),
])
def test_model_form_matches_ssd_chunked(Bsz, S, H, P, N, chunk):
    """The model's form, B and C shared by the heads of a batch row, with
    S a multiple of the chunk and not (padded with dt = 0 steps)."""
    rng = np.random.default_rng(S * H)
    x = rng.normal(size=(Bsz, S, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(Bsz, S, H))) * 0.1).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.normal(size=(Bsz, S, N)).astype(np.float32)
    Cm = rng.normal(size=(Bsz, S, N)).astype(np.float32)
    arrays = (x, dt, A, Bm, Cm)
    y, st = ssd_chunked(*_t(arrays), min(chunk, S))
    jy, jst = j_ssd_chunked(*map(jnp.asarray, arrays), min(chunk, S))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    # the same scan per head, B and C repeated: the sequential oracle
    xh = x.transpose(0, 2, 1, 3).reshape(Bsz * H, S, P)
    dth = dt.transpose(0, 2, 1).reshape(Bsz * H, S)
    ah = np.tile(A, Bsz)
    Bh, Ch = (np.repeat(m, H, axis=0) for m in (Bm, Cm))
    ry, rst = ssd_ref(*_t((xh, dth, ah, Bh, Ch)))
    np.testing.assert_allclose(
        y.numpy().transpose(0, 2, 1, 3).reshape(Bsz * H, S, P), ry.numpy(),
        **TOL)
    np.testing.assert_allclose(st.numpy().reshape(Bsz * H, P, N),
                               rst.numpy(), **TOL)


def test_cuda_wrapper_refuses_what_it_cannot_take():
    """Nothing falls back: ``impl="cuda"`` needs CUDA tensors, and the
    launcher's own refusals raise ``ValueError``."""
    x, dt, a, Bm, Cm = _t(_per_head(0, 2, 16, 16, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd(x, dt, a, Bm, Cm, impl="cuda")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ssd_ops.ssd_cuda_heads(x[:, :, None], dt[:, :, None], a, Bm, Cm)
    for rc in ssd_ops._REFUSED:
        with pytest.raises(ValueError, match=f"status {rc}"):
            backend.raise_on(rc, "ssd", ssd_ops._REFUSED)
    assert backend.SSD.launches == 0
