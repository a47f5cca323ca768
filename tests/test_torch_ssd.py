"""The port's SSD scan (its plain versions, which a CPU tensor runs)
against the JAX package.

The same inputs, drawn from a seeded numpy generator, go through the
Pallas kernel in interpret mode (``ssd_op``, as ``tests/test_kernels.py``
runs it), the sequential oracle ``ssd_ref`` and the model's
``layers.ssd_chunked``, and through the port's ``ssd`` / ``ssd_ref`` /
``ssd_chunked`` on CPU tensors (from a zero state and from a carried
one), at the four shapes of ``tests/test_kernels.py`` with its tolerances (atol 5e-4, rtol 1e-3: the
chunked and sequential forms sum in different orders, in float32).  The
CUDA kernel's own schedule (its passes at its 256-row chunk, C B^T
once per batch row, every product in 3xTF32) is emulated in torch and
held to the same references at the same tolerance.  The CUDA kernel is
held against the plain versions on the card by ``chip_smoke.py``.
"""
import sys

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


# ---------------------------------------------------------------------------
# The CUDA kernel's schedule, emulated: its passes at its own chunk,
# every product in 3xTF32
# ---------------------------------------------------------------------------


def tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: to nearest, ties away from zero, keeping 10
    mantissa bits (the float32 pattern with its low 13 bits cleared).  On
    the sign-magnitude bit pattern, adding half of the dropped unit rounds
    the magnitude half away from zero."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_rz(v: torch.Tensor) -> torch.Tensor:
    """To tf32 toward zero: the low 13 bits cleared."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's ``mma.sync`` steps take it, in CUTLASS's fast
    accurate split: big = v toward zero, small = v - big to nearest, ties
    away (as ``cvt.rna.tf32.f32``); then small b' + big small' + big big'
    in float32 (a product of two tf32 values is exact in float32; only
    the sums round, in another order than the tensor cores')."""
    ab, bb = tf32_rz(a), tf32_rz(b)
    return tf32(a - ab) @ bb + ab @ tf32(b - bb) + ab @ bb


def emulate_ssd_kernel(x, dt, a, Bm, Cm, h0=None, entering=False):
    """``csrc/ssd.cu`` in the model's layout: x (B, S, H, P), dt (B, S, H),
    a (B * H,), Bm/Cm (B, S, N) shared by the heads, the initial state h0
    (B * H, P, N) or None for zero -> y (B, S, H, P) and the final state
    (B * H, P, N); with ``entering`` also the kernel's scratch: G (B, 1,
    c, Q, Q), cum (B, H, c, Q) and the states entering each chunk (B, H,
    c, P, N).  The kernel's chunk, S padded with zero rows (dt = 0: decay
    1, no input)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = ssd_ops.CHUNK
    nc = -(-S // Q)
    pad = nc * Q - S
    fpad = torch.nn.functional.pad
    xc = fpad(x, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, H, P) \
        .permute(0, 3, 1, 2, 4)                              # (B,H,c,Q,P)
    dtc = fpad(dt, (0, 0, 0, pad)).reshape(Bsz, nc, Q, H) \
        .permute(0, 3, 1, 2)                                 # (B,H,c,Q)
    Bc, Cc = (fpad(m, (0, 0, 0, pad)).reshape(Bsz, 1, nc, Q, N)
              for m in (Bm, Cm))
    # 1. the cumulative decay of each chunk
    cum = torch.cumsum(dtc * a.reshape(Bsz, H, 1, 1), dim=-1)
    # 2. G = C B^T once per batch row and chunk, its lower triangle
    low = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    G = torch.where(low, mm3(Cc, Bc.transpose(-1, -2)), 0.0)
    # 3. the chunk states, s^T = (B o w)^T x with w = exp(cum_last - cum) dt
    w = torch.exp(cum[..., -1:] - cum) * dtc
    sT = mm3((Bc * w[..., None]).transpose(-1, -2), xc)      # (B,H,c,N,P)
    # 4. state passing: the state entering each chunk, and the last one
    h = torch.zeros((Bsz, H, P, N)) if h0 is None \
        else h0.reshape(Bsz, H, P, N)
    states = []
    for c in range(nc):
        states.append(h)
        h = torch.exp(cum[:, :, c, -1])[..., None, None] * h \
            + sT[:, :, c].transpose(-1, -2)
    hp = torch.stack(states, dim=2)                          # (B,H,c,P,N)
    # 5. the chunk scan: exp(cum_i - cum_j) only where i >= j
    seg = torch.where(low, cum[..., :, None] - cum[..., None, :], 0.0)
    M = torch.where(low, torch.exp(seg) * dtc[..., None, :] * G, 0.0)
    y = mm3(M, xc) + mm3(Cc * torch.exp(cum)[..., None],
                         hp.transpose(-1, -2))
    y = y.permute(0, 2, 3, 1, 4).reshape(Bsz, nc * Q, H, P)[:, :S]
    if entering:
        return y, h.reshape(Bsz * H, P, N), G, cum, hp
    return y, h.reshape(Bsz * H, P, N)


def test_tf32_split_rounds_as_the_kernel():
    one = 1.0
    ulp = 2.0 ** -10                       # tf32's unit at 1.0
    v = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2e-7,
                      one + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0]
    assert tf32(v).tolist() == want
    r = torch.from_numpy(np.random.default_rng(0).normal(size=1000)
                         .astype(np.float32))
    assert bool(((tf32(r).view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((tf32(r) - r).abs() / r.abs()).max()) <= 2.0 ** -11
    # the split: big toward zero, small the rest to nearest; big + small
    # holds v to about 2^-21 of it, a NaN stays in big
    assert tf32_rz(v).tolist() == [one, -one, one, one + ulp, 3.0, 0.0]
    big = tf32_rz(r)
    assert bool((big.abs() <= r.abs()).all())
    rest = (big + tf32(r - big) - r).abs() / r.abs()
    assert float(rest.max()) <= 2.0 ** -21
    nan = torch.tensor([float("nan"), float("inf")])
    assert bool(torch.isnan(tf32_rz(nan)[0])) and tf32_rz(nan)[1] == nan[1]


@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (4, 256, 64, 32, 64), (2, 128, 32, 16, 128), (8, 512, 64, 64, 128),
    (1, 64, 16, 8, 32), (2, 300, 32, 16, 100), (3, 77, 64, 128, 77),
])
def test_emulated_kernel_matches_pallas_kernel_and_oracle(BH, S, P, N, chunk):
    """The kernel's passes in 3xTF32, per head (H = 1), at the kernel
    tests' shapes, a ragged S over two chunks and an S below one chunk,
    against the Pallas kernel in interpret mode and the sequential
    oracle at ``tests/test_kernels.py``'s tolerance."""
    arrays = _per_head(BH * S + 1, BH, S, P, N)
    x, dt, a, Bm, Cm = _t(arrays)
    y, st = emulate_ssd_kernel(x[:, :, None], dt[:, :, None], a, Bm, Cm)
    y = y[:, :, 0]
    jy, jst = ssd_op(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    ry, rst = ssd_ref(x, dt, a, Bm, Cm)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), rst.numpy(), **TOL)


@pytest.mark.parametrize("Bsz,S,H,P,N", [
    (2, 77, 4, 16, 32), (1, 600, 8, 64, 8), (2, 260, 4, 32, 128),
])
def test_emulated_kernel_model_form_shares_B_and_C(Bsz, S, H, P, N):
    """The model's form, C B^T formed once per batch row and chunk and
    shared by its H heads: against the model's ``layers.ssd_chunked`` in
    the JAX package and the sequential oracle per head, B and C
    repeated."""
    rng = np.random.default_rng(7 * S + H)
    x = rng.normal(size=(Bsz, S, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(Bsz, S, H))) * 0.1).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.normal(size=(Bsz, S, N)).astype(np.float32)
    Cm = rng.normal(size=(Bsz, S, N)).astype(np.float32)
    a = np.tile(A, Bsz)
    y, st = emulate_ssd_kernel(*_t((x, dt, a, Bm, Cm)))
    jy, jst = j_ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                            min(256, S))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(),
                               np.asarray(jst).reshape(Bsz * H, P, N), **TOL)
    xh = x.transpose(0, 2, 1, 3).reshape(Bsz * H, S, P)
    dth = dt.transpose(0, 2, 1).reshape(Bsz * H, S)
    Bh, Ch = (np.repeat(m, H, axis=0) for m in (Bm, Cm))
    ry, rst = ssd_ref(*_t((xh, dth, a, Bh, Ch)))
    np.testing.assert_allclose(
        y.numpy().transpose(0, 2, 1, 3).reshape(Bsz * H, S, P), ry.numpy(),
        **TOL)
    np.testing.assert_allclose(st.numpy(), rst.numpy(), **TOL)


@pytest.mark.parametrize("Bsz,S,H,P,N", [(2, 77, 4, 16, 32),
                                          (1, 600, 2, 64, 13)])
def test_emulated_kernel_from_a_carried_state(Bsz, S, H, P, N):
    """The kernel's passes from an initial state h0 (the state pass starts
    from it, and chunk 0 reads it as its entering state): against the
    reference's ``layers.ssd_chunked`` with ``init_state`` and the port's
    plain version."""
    rng = np.random.default_rng(3 * S + N)
    x = rng.normal(size=(Bsz, S, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(Bsz, S, H))) * 0.1).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.normal(size=(Bsz, S, N)).astype(np.float32)
    Cm = rng.normal(size=(Bsz, S, N)).astype(np.float32)
    h0 = rng.normal(size=(Bsz, H, P, N)).astype(np.float32)
    y, st = emulate_ssd_kernel(*_t((x, dt, np.tile(A, Bsz), Bm, Cm)),
                               torch.from_numpy(h0).reshape(Bsz * H, P, N))
    jy, jst = j_ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                            min(256, S), jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(),
                               np.asarray(jst).reshape(Bsz * H, P, N), **TOL)
    py, pst = ssd_chunked(*_t((x, dt, A, Bm, Cm)), 64,
                          torch.from_numpy(h0))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(pst.numpy(), np.asarray(jst), **TOL)


def test_plain_tf32_would_not_hold_the_tolerance(monkeypatch):
    """Why the kernel runs 3xTF32: the same passes with each product on
    tf32 operands alone (about three decimal digits) miss
    ``tests/test_kernels.py``'s tolerance against the oracle."""
    monkeypatch.setattr(sys.modules[__name__], "mm3",
                        lambda a, b: tf32(a) @ tf32(b))
    x, dt, a, Bm, Cm = _t(_per_head(5, 4, 512, 64, 128))
    y, _ = emulate_ssd_kernel(x[:, :, None], dt[:, :, None], a, Bm, Cm)
    ry, _ = ssd_ref(x, dt, a, Bm, Cm)
    assert not np.allclose(y[:, :, 0].numpy(), ry.numpy(), **TOL)


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
