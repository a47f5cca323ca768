"""The port's SSD backward (its plain version, which a CPU tensor runs)
against the JAX package, and the prefill from a carried SSD state.

The same inputs, drawn from a seeded numpy generator, go through
``jax.vjp`` of the reference's ``repro.models.layers.ssd_chunked`` (JAX
differentiates the jnp code: the reference has no custom VJP) and
through the port's ``ssd_chunked_bwd_ref`` and torch autograd of its
``ssd_chunked`` on CPU tensors (the ``_SSDChunked`` Function: the plain
forward, then ``ssd_chunked_bwd_ref``), with and without an initial
state, with a zero and a non-zero gradient of the final state, S a
multiple of the chunk, ragged against it and below one chunk, N = 13,
P in {16, 64}, B and C shared by H > 1 heads.

Tolerance: each of dx, ddt, dA, dB, dC and dinit within 1e-4 of its own
largest |entry| (TOL_SHARE).  Both sides compute in float32, but in
other orders: the reference's autodiff of the chunked jnp code, the
port's written-out passes (dcum through dy . y, reverse cumsums, sums
over up to 256 rows a chunk and over the heads for dB and dC); the
plain version lands within 5e-6 of the largest entry at these shapes,
so the tolerance leaves a margin of 20 for other shapes and seeds.  The
CUDA kernel (``csrc/ssd_bwd.cu``) is held against the plain version on
the card by ``chip_smoke.py`` (``SSD_BWD_TOL``).

The kernel's own schedule is emulated in torch (``emulate_ssd_bwd``):
its passes at its 256-row chunk, the forward's passes re-run from h0,
every product in 3xTF32 (``mm3`` of ``tests/test_torch_ssd.py``), M =
sum_h dt E o dy x^T per batch row and chunk summed in head order, then
dB and dC as one product each, k over M's triangle and then over (head,
p) in order.  It must land within a third of the tolerance.  The dCB
form itself (``ssd_dcb_grads``: the heads summed first) equals the
per-head form in float64 to 1e-12 of each output's largest entry.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.layers import ssd_chunked as j_ssd_chunked
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.kernels import backend, build
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import (ssd, ssd_chunked, ssd_chunked_bwd_ref,
                                    ssd_chunked_ref)
from repro_torch.kernels.ssd.ref import ssd_dcb_grads
from repro_torch.models import layers as PL
from test_torch_ssd import emulate_ssd_kernel, mm3

TOL_SHARE = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")

# (B, S, H, P, N, chunk): S a multiple of the chunk; ragged; below one
# chunk; P = 64 with N = 13 and ragged; the kernel's 256-row chunk over
# three chunks, ragged, at N = 128
SHAPES = [
    (2, 64, 4, 16, 32, 32),
    (2, 77, 4, 16, 32, 32),
    (1, 20, 3, 16, 13, 32),
    (2, 300, 4, 64, 13, 128),
    (1, 600, 2, 64, 128, 256),
]
# the emulated kernel's shapes: its chunk is 256 whatever the caller's
KERNEL_SHAPES = [
    (2, 77, 4, 16, 32), (1, 20, 3, 16, 13), (2, 300, 4, 64, 13),
    (1, 600, 2, 64, 128), (1, 260, 2, 32, 8),
]


def _inputs(seed, Bsz, S, H, P, N):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(Bsz, S, H, P)).astype(np.float32),
        "dt": (np.abs(rng.normal(size=(Bsz, S, H))) * 0.1)
        .astype(np.float32),
        "A": -np.linspace(1.0, 16.0, H).astype(np.float32),
        "Bm": rng.normal(size=(Bsz, S, N)).astype(np.float32),
        "Cm": rng.normal(size=(Bsz, S, N)).astype(np.float32),
        "h0": rng.normal(size=(Bsz, H, P, N)).astype(np.float32),
        "dy": rng.normal(size=(Bsz, S, H, P)).astype(np.float32),
        "dfin": rng.normal(size=(Bsz, H, P, N)).astype(np.float32),
    }


def _jax_vjp(v, chunk, init, dfin):
    """The reference's ``ssd_chunked`` and its vjp: (y, final state) and
    the six gradients (dinit None without an initial state)."""
    args = [jnp.asarray(v[k]) for k in ("x", "dt", "A", "Bm", "Cm")]
    if init:
        (y, st), vjp = jax.vjp(
            lambda *a: j_ssd_chunked(*a[:5], chunk, a[5]), *args,
            jnp.asarray(v["h0"]))
    else:
        (y, st), vjp = jax.vjp(lambda *a: j_ssd_chunked(*a, chunk), *args)
    d_st = v["dfin"] if dfin else np.zeros_like(v["dfin"])
    grads = vjp((jnp.asarray(v["dy"]), jnp.asarray(d_st)))
    grads = [np.asarray(g) for g in grads] + ([] if init else [None])
    return (np.asarray(y), np.asarray(st)), grads


def _hold(got, want, share):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, (name, g.shape, w.shape)
        top = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= share * top, f"{name}: {err} > {share} x {top}"


def _t(v, *keys):
    return [torch.from_numpy(v[k]) for k in keys]


@pytest.mark.parametrize("dfin", [False, True], ids=["dfin0", "dfin"])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("Bsz,S,H,P,N,chunk", SHAPES)
def test_bwd_ref_matches_jax_vjp(Bsz, S, H, P, N, chunk, init, dfin):
    v = _inputs(S * H + N, Bsz, S, H, P, N)
    _, want = _jax_vjp(v, chunk, init, dfin)
    x, dt, A, Bm, Cm, h0, dy, df = _t(v, "x", "dt", "A", "Bm", "Cm", "h0",
                                      "dy", "dfin")
    got = ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, chunk, h0 if init else None,
                              dy, df if dfin else None)
    _hold(got, want, TOL_SHARE)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("Bsz,S,H,P,N,chunk", [SHAPES[1], SHAPES[3]])
def test_function_backward_matches_jax_vjp(Bsz, S, H, P, N, chunk, remat):
    """Torch autograd of the port's ``ssd_chunked`` on CPU tensors: the
    ``_SSDChunked`` Function's saved tensors, A expanded from (H,) to
    (B * H,) and summed back by autograd, the initial state's gradient,
    and under ``torch.utils.checkpoint`` the forward run again."""
    v = _inputs(7 * S + H, Bsz, S, H, P, N)
    (jy, jst), want = _jax_vjp(v, chunk, True, True)
    leaves = [t.requires_grad_(True) for t in
              _t(v, "x", "dt", "A", "Bm", "Cm", "h0")]

    def f(*a):
        return ssd_chunked(*a[:5], chunk, init_state=a[5])

    if remat:
        y, st = torch.utils.checkpoint.checkpoint(f, *leaves,
                                                  use_reentrant=False)
    else:
        y, st = f(*leaves)
    np.testing.assert_allclose(y.detach().numpy(), jy, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(st.detach().numpy(), jst, atol=5e-4,
                               rtol=1e-3)
    dy, df = _t(v, "dy", "dfin")
    torch.autograd.backward((y, st), (dy, df))
    _hold([t.grad for t in leaves], want, TOL_SHARE)
    assert backend.SSD.launches == backend.SSD_BWD.launches == 0


def test_function_takes_no_gradient_of_an_unused_state():
    """A loss of y alone: the final state's gradient is None, taken as
    zero, and no initial state means no dinit."""
    v = _inputs(3, 2, 40, 2, 16, 8)
    (_, _), want = _jax_vjp(v, 16, False, False)
    leaves = [t.requires_grad_(True) for t in
              _t(v, "x", "dt", "A", "Bm", "Cm")]
    y, _ = ssd_chunked(*leaves, 16)
    y.backward(torch.from_numpy(v["dy"]))
    _hold([t.grad for t in leaves] + [None], want, TOL_SHARE)


def test_pallas_signature_is_differentiable_too():
    """``ssd`` (per-head B and C, H = 1) goes through the same Function:
    its gradients equal the model form's on B and C repeated per head."""
    v = _inputs(11, 1, 50, 3, 16, 8)
    x = torch.from_numpy(v["x"][0].transpose(1, 0, 2).copy())  # (H, S, P)
    dt = torch.from_numpy(v["dt"][0].T.copy())
    a = torch.from_numpy(v["A"])
    Bm = torch.from_numpy(np.repeat(v["Bm"], 3, axis=0))
    Cm = torch.from_numpy(np.repeat(v["Cm"], 3, axis=0))
    leaves = [t.requires_grad_(True) for t in (x, dt, a, Bm, Cm)]
    y, _ = ssd(*leaves, chunk=16)
    dy = torch.from_numpy(v["dy"][0].transpose(1, 0, 2).copy())
    y.backward(dy)
    (_, _), want = _jax_vjp(v, 16, False, False)
    np.testing.assert_allclose(x.grad.numpy().transpose(1, 0, 2),
                               want[0][0], atol=TOL_SHARE * 10)
    np.testing.assert_allclose(a.grad.numpy(), want[2],
                               atol=TOL_SHARE * np.abs(want[2]).max())
    np.testing.assert_allclose(Bm.grad.sum(0).numpy(), want[3][0],
                               atol=TOL_SHARE * np.abs(want[3]).max())


@pytest.mark.parametrize("Bsz,S,H,P,N,chunk",
                         SHAPES + [(2, 90, 1, 16, 8, 32)])
def test_dcb_form_equals_the_per_head_form(Bsz, S, H, P, N, chunk):
    """``ssd_dcb_grads`` (M summed over the heads, then one product over
    M's triangle and one of depth H P) against each head's dB and dC
    written out and summed over the heads, in float64 on the chunked
    inputs (S ragged: the padded rows zero, as the plain version pads)."""
    rng = np.random.default_rng(S + 7 * H + N)
    nc = -(-S // chunk)
    live = (torch.arange(nc * chunk) < S).double().reshape(nc, chunk)

    def draw(*shape, rows=True):
        t = torch.from_numpy(rng.normal(size=shape))
        return t * live.reshape(1, nc, chunk, *[1] * (len(shape) - 3)) \
            if rows else t

    xc, dyc = draw(Bsz, nc, chunk, H, P), draw(Bsz, nc, chunk, H, P)
    dtc = draw(Bsz, nc, chunk, H).abs() * 0.1
    Bc, Cc = draw(Bsz, nc, chunk, N), draw(Bsz, nc, chunk, N)
    gh, h_prev = (draw(Bsz, nc, H, P, N, rows=False) for _ in range(2))
    cum = torch.cumsum(dtc * -torch.linspace(1.0, 16.0, H,
                                             dtype=torch.float64), dim=2)
    low = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))[..., None]
    E = torch.exp((cum[:, :, :, None] - cum[:, :, None])
                  .masked_fill(~low, float("-inf")))
    to_end, ecum = torch.exp(cum[:, :, -1:] - cum), torch.exp(cum)
    dB, dC = ssd_dcb_grads(xc, dyc, dtc, E, Bc, Cc, to_end, ecum, gh, h_prev)
    wB, wC = torch.zeros_like(dB), torch.zeros_like(dC)
    for h in range(H):
        ED = E[..., h] * torch.einsum("bctp,bcsp->bcts", dyc[..., h, :],
                                      xc[..., h, :])
        wB += dtc[..., h, None] * (
            torch.einsum("bcts,bctn->bcsn", ED, Cc) + to_end[..., h, None]
            * torch.einsum("bcsp,bcpn->bcsn", xc[..., h, :], gh[:, :, h]))
        wC += torch.einsum("bcts,bcs,bcsn->bctn", ED, dtc[..., h], Bc) + \
            ecum[..., h, None] * torch.einsum(
                "bctp,bcpn->bctn", dyc[..., h, :], h_prev[:, :, h])
    for name, got, want in (("dB", dB, wB), ("dC", dC, wC)):
        top = float(want.abs().max())
        err = float((got - want).abs().max())
        assert top > 0 and err <= 1e-12 * top, (name, err, top)


def test_bwd_scratch_holds_no_per_head_square_or_row_tensor(monkeypatch):
    """At mamba2-370m's training shape the wrapper allocates
    ``bwd_scratch``'s tensors and nothing else beside its outputs: under
    100 MB, no (B H, c, Q, Q) and no (B H, S, N) tensor.  The wrapper runs
    on meta tensors with a stand-in library; ``chip_smoke.time_ssd_bwd``
    reports ``bwd_scratch_bytes`` from the same helper."""
    import chip_smoke as CS
    Bsz, S, H, P, N = CS.SERVE_BATCH, CS.SERVE_PROMPT, 32, 64, 128
    nc, Q = -(-S // ssd_ops.CHUNK), ssd_ops.CHUNK
    meta = torch.device("meta")
    f32 = dict(dtype=torch.float32, device=meta)
    x = torch.empty((Bsz, S, H, P), **f32)
    dt = torch.empty((Bsz, S, H), **f32)
    a = torch.empty((Bsz * H,), **f32)
    Bm, Cm = (torch.empty((Bsz, S, N), **f32) for _ in range(2))
    made, calls = [], []
    empty = torch.empty

    def recording_empty(*args, **kw):
        made.append(tuple(args[0]))
        return empty(*args, **kw)

    class Lib:
        def ssd_bwd(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(ssd_ops, "_check_all", lambda named, ndims: meta)
    monkeypatch.setattr(build, "lib", Lib)
    monkeypatch.setattr(backend, "stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", recording_empty)
    monkeypatch.setattr(backend.SSD_BWD, "launches", 0)
    ssd_ops.ssd_bwd_cuda_heads(x, dt, a, Bm, Cm, None, x, x, None)
    want = ssd_ops.bwd_scratch(Bsz, H, S, P, N)
    assert made == list(want.values())
    assert len(calls) == 1 and len(calls[0]) == 15 + len(want) + 15
    assert (Bsz * H, nc, Q, Q) not in made and (Bsz * H, S, N) not in made
    nbytes = ssd_ops.bwd_scratch_bytes(Bsz, H, S, P, N)
    assert nbytes == 4 * sum(int(np.prod(s)) for s in made) < 100e6
    assert backend.SSD_BWD.launches == 1


def test_bwd_flops_count_the_triangles_once_a_batch_row():
    """The backward's work at mamba2-370m's training shape: 31.02 GFLOP
    at the kernels' Q = 256, and the least over every chunk length 22.97
    GFLOP at Q = 16 (M's two uses once per batch row, not per head)."""
    import chip_smoke as CS
    shape = (CS.SERVE_BATCH, CS.SERVE_PROMPT, 32, 64, 128)
    assert CS.ssd_bwd_flops_at(*shape, 256) == 31_020_023_808
    assert CS.ssd_bwd_flops(*shape) == (22_966_960_128, 16)


# ---------------------------------------------------------------------------
# The CUDA kernel's schedule, emulated: its passes at its own chunk, every
# product in 3xTF32, M summed over the heads in head order, then dB and dC
# one product each over M's triangle and (head, p)
# ---------------------------------------------------------------------------


def emulate_ssd_bwd(x, dt, a, Bm, Cm, h0, y, dy, dfin):
    """``csrc/ssd_bwd.cu`` in the model's layout: x, dy (B, S, H, P), dt
    (B, S, H), a (B * H,), Bm/Cm (B, S, N), h0 and dfin (B * H, P, N) or
    None, y the forward's output -> dx, ddt, da (B * H,), dB, dC, dinit
    (B * H, P, N)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = ssd_ops.CHUNK
    nc = -(-S // Q)
    pad = nc * Q - S
    fpad = torch.nn.functional.pad
    # the forward's passes, run again: G, cum, the states entering each
    # chunk and the final one
    _, hfin, G, cum, hp = emulate_ssd_kernel(x, dt, a, Bm, Cm, h0,
                                             entering=True)

    def heads(t):                                            # (B,H,c,Q,P)
        return fpad(t, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, H, P) \
            .permute(0, 3, 1, 2, 4)

    xc, dyc, yc = heads(x), heads(dy), heads(y)
    dtc = fpad(dt, (0, 0, 0, pad)).reshape(Bsz, nc, Q, H).permute(0, 3, 1, 2)
    Bc, Cc = (fpad(m, (0, 0, 0, pad)).reshape(Bsz, 1, nc, Q, N)
              for m in (Bm, Cm))
    low = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    ecum = torch.exp(cum)
    to_end = torch.exp(cum[..., -1:] - cum)
    # 1. u_c^T = (C o exp(cum))^T dy, then the reverse state pass
    uT = mm3((Cc * ecum[..., None]).transpose(-1, -2), dyc)   # (B,H,c,N,P)
    g = torch.zeros((Bsz, H, P, N)) if dfin is None \
        else dfin.reshape(Bsz, H, P, N)
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = g
        g = torch.exp(cum[:, :, c, -1])[..., None, None] * g \
            + uT[:, :, c].transpose(-1, -2)
    gh = torch.stack(leaving, dim=2)                         # (B,H,c,P,N)
    # 2. M = sum_h D o E o dt_s per batch row and chunk, the heads added in
    #    order: D = dy x^T, E = exp(cum_t - cum_s), both where t >= s
    D = torch.where(low, mm3(dyc, xc.transpose(-1, -2)), 0.0)
    seg = torch.where(low, cum[..., :, None] - cum[..., None, :], 0.0)
    E = torch.where(low, torch.exp(seg), 0.0)
    term = D * (E * dtc[..., None, :])
    M = term[:, 0]
    for h in range(1, H):
        M = M + term[:, h]                                   # (B,c,Q,Q)
    # 3. r = (E o G)^T dy + (B o exp(cum_last - cum)) gh^T; dx, x . r, dcum
    r = mm3((E * G).transpose(-1, -2), dyc) + \
        mm3(Bc * to_end[..., None], gh.transpose(-1, -2))
    dx = r * dtc[..., None]
    direct = (xc * r).sum(-1)
    dcum = (dyc * yc).sum(-1) - dtc * direct
    # 4. dB = [M^T | x o w_B] [C ; gh] and dC = [M | dy o w_C] [B ; h_{c-1}],
    #    k over M's triangle, then over (h, p) in order
    def by_hp(t):                           # (B,H,c,R,K) -> (B,c,R,H K)
        return t.permute(0, 2, 3, 1, 4).reshape(Bsz, nc, t.shape[3], -1)

    def hp_rows(t):                         # (B,H,c,P,N) -> (B,c,H P,N)
        return t.transpose(1, 2).reshape(Bsz, nc, H * P, N)

    wB = (dtc * to_end)[..., None] * xc
    wC = ecum[..., None] * dyc
    dB = mm3(torch.cat([M.transpose(-1, -2), by_hp(wB)], -1),
             torch.cat([Cc[:, 0], hp_rows(gh)], -2))
    dC = mm3(torch.cat([M, by_hp(wC)], -1),
             torch.cat([Bc[:, 0], hp_rows(hp)], -2))
    # 5. <gh_c, h_c> at each chunk's last row, the reverse cumsum, ddt, da
    h_next = torch.cat([hp[:, :, 1:], hfin.reshape(Bsz, H, 1, P, N)], dim=2)
    dcum[..., -1] += (gh * h_next).sum((-1, -2))
    rev = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    ddt = direct + a.reshape(Bsz, H, 1, 1) * rev
    da_c = (dtc * rev).sum(-1)                               # (B,H,c)
    da = da_c[..., 0]
    for c in range(1, nc):
        da = da + da_c[..., c]

    def rows(t, *tail):
        return t.permute(0, 2, 3, 1, *range(4, 4 + len(tail))) \
            .reshape(Bsz, nc * Q, H, *tail)[:, :S]

    return (rows(dx, P), rows(ddt), da.reshape(Bsz * H),
            dB.reshape(Bsz, nc * Q, N)[:, :S],
            dC.reshape(Bsz, nc * Q, N)[:, :S],
            g.reshape(Bsz * H, P, N))


@pytest.mark.parametrize("init", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("Bsz,S,H,P,N", KERNEL_SHAPES)
def test_emulated_kernel_bwd_within_a_third_of_the_tolerance(Bsz, S, H, P,
                                                             N, init):
    v = _inputs(5 * S + N, Bsz, S, H, P, N)
    _, want = _jax_vjp(v, min(256, S), init, True)
    x, dt, Bm, Cm, dy = _t(v, "x", "dt", "Bm", "Cm", "dy")
    a = torch.from_numpy(np.tile(v["A"], Bsz))
    h0 = torch.from_numpy(v["h0"]).reshape(Bsz * H, P, N) if init else None
    dfin = torch.from_numpy(v["dfin"]).reshape(Bsz * H, P, N)
    y, _ = emulate_ssd_kernel(x, dt, a, Bm, Cm, h0)
    dx, ddt, da, dB, dC, dinit = emulate_ssd_bwd(x, dt, a, Bm, Cm, h0, y, dy,
                                                 dfin)
    got = (dx, ddt, da.reshape(Bsz, H).sum(0), dB, dC,
           dinit.reshape(Bsz, H, P, N) if init else None)
    _hold(got, want, TOL_SHARE / 3)


def test_da_bound_holds_float32_where_its_largest_entry_alone_does_not():
    """Why ``chip_smoke.py`` holds da to its summands' magnitude as well
    as to 1e-4 of its largest entry: da = sum_t dcum_t cumdt_t is a sum
    whose terms cancel, so a float32 evaluation can miss 1e-4 of |da| on
    a correct computation.  On the card check's own draws (its input
    generator, seeds 1-8, its cases below S = 1000), the float32 plain
    version misses 1e-4 of the largest entry on one of the 48 and stays
    within SSD_BWD_DA_UNIT of the summand magnitude on all; so does the
    emulated kernel on the worst of them."""
    import chip_smoke as CS
    dev = torch.device("cpu")
    shares, worst = [], None
    for seed in range(1, 9):
        rng = np.random.default_rng(seed)
        for case in [c for c in CS.SSD_BWD_CASES if c[1] < 1000]:
            Bsz, S, H, P, N, init, dfin = case
            x, dt, A, Bm, Cm = CS._ssd_inputs(rng, dev, Bsz, S, H, P, N=N,
                                              per_head=False)
            a = A.repeat(Bsz)
            h0 = torch.from_numpy(rng.standard_normal(
                (Bsz * H, P, N), np.float32)) * 0.5 if init else None
            ds = torch.from_numpy(rng.standard_normal(
                (Bsz * H, P, N), np.float32)) if dfin else None
            dy = torch.from_numpy(rng.standard_normal((Bsz, S, H, P),
                                                      np.float32))
            h4 = None if h0 is None else h0.reshape(Bsz, H, P, N)
            d4 = None if ds is None else ds.reshape(Bsz, H, P, N)
            args = (x, dt, a, Bm, Cm, min(256, S), h4)
            got = ssd_chunked_bwd_ref(*args, dy, d4)[2]
            d64 = [t.double() if isinstance(t, torch.Tensor) else t
                   for t in args]
            ref = ssd_chunked_bwd_ref(*d64, dy.double(),
                                      None if d4 is None else d4.double())
            y64, _ = ssd_chunked_ref(*d64)
            bound = CS.SSD_BWD_TOL * ref[2].abs().max() + CS.SSD_BWD_DA_UNIT \
                * CS._da_scale(d64[0], d64[1], dy.double(), y64, ref[0])
            err = (got.double() - ref[2]).abs()
            assert bool((err <= bound).all()), (seed, case)
            shares.append(float(err.max() / ref[2].abs().max()))
            if worst is None or shares[-1] > worst[0]:
                worst = (shares[-1], x, dt, a, Bm, Cm, h0, dy, ds, ref,
                         bound)
    assert sum(sh > CS.SSD_BWD_TOL for sh in shares) == 1
    _, x, dt, a, Bm, Cm, h0, dy, ds, ref, bound = worst
    y, _ = emulate_ssd_kernel(x, dt, a, Bm, Cm, h0)
    da = emulate_ssd_bwd(x, dt, a, Bm, Cm, h0, y, dy, ds)[2]
    assert bool(((da.double() - ref[2]).abs() <= bound).all())


def test_cuda_bwd_wrapper_refuses_cpu_tensors():
    """Nothing falls back: the backward's launcher takes CUDA tensors
    only, and its own refusals raise ``ValueError``."""
    v = _inputs(0, 1, 16, 2, 16, 8)
    x, dt, Bm, Cm, dy = _t(v, "x", "dt", "Bm", "Cm", "dy")
    a = torch.from_numpy(np.tile(v["A"], 1))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ssd_ops.ssd_bwd_cuda_heads(x, dt, a, Bm, Cm, None, x, dy, None)
    for rc in ssd_ops._REFUSED:
        with pytest.raises(ValueError, match=f"status {rc}"):
            backend.raise_on(rc, "ssd_bwd", ssd_ops._REFUSED)
    assert backend.SSD_BWD.launches == 0


# ---------------------------------------------------------------------------
# The prefill from a carried SSD state
# ---------------------------------------------------------------------------


def _mixer_pair(seed=0):
    jcfg = dataclasses.replace(j_smoke("mamba2-370m"), dtype="float32")
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    pp = model_params_from_numpy(pcfg, jax.tree.map(np.asarray, jp), "cpu")
    # the first unit's mixer: the reference stacks the units on a leading
    # axis, the port keeps a list of them
    jmix = jax.tree.map(lambda t: t[0], jp["units"]["layer0"]["mixer"])
    return jcfg, jmix, pcfg, pp["units"][0]["layer0"]["mixer"]


def _state(cfg, rng, Bsz):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    K = s.d_conv - 1
    return {"conv_x": rng.normal(size=(Bsz, K, d_in)).astype(np.float32),
            "conv_B": rng.normal(size=(Bsz, K, s.d_state)).astype(np.float32),
            "conv_C": rng.normal(size=(Bsz, K, s.d_state)).astype(np.float32),
            "ssd": rng.normal(size=(Bsz, nh, s.head_dim, s.d_state))
            .astype(np.float32) * 0.3}


def test_prefill_from_a_carried_state_matches_reference():
    jcfg, jmix, pcfg, pmix = _mixer_pair()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, pcfg.d_model)).astype(np.float32)
    st = _state(pcfg, rng, 2)
    jy, jst = JL.mamba_forward(jcfg, jmix, jnp.asarray(x),
                               state={k: jnp.asarray(v)
                                      for k, v in st.items()})
    py, pst = PL.mamba_forward(pcfg, pmix, torch.from_numpy(x),
                               state={k: torch.from_numpy(v)
                                      for k, v in st.items()})
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=5e-4,
                               rtol=1e-3)
    for k in st:
        np.testing.assert_allclose(pst[k].numpy(), np.asarray(jst[k]),
                                   atol=5e-4, rtol=1e-3)


def test_two_half_prefills_equal_one_whole_prefill():
    """A prefill of S tokens, and one of the first half followed by one of
    the second half from its state: the same outputs and final state, in
    the port and in the reference."""
    jcfg, jmix, pcfg, pmix = _mixer_pair(seed=2)
    x = np.random.default_rng(4).normal(size=(2, 48, pcfg.d_model)) \
        .astype(np.float32)
    h = x.shape[1] // 2
    jy, jst = JL.mamba_forward(jcfg, jmix, jnp.asarray(x))
    j1, js1 = JL.mamba_forward(jcfg, jmix, jnp.asarray(x[:, :h]))
    j2, js2 = JL.mamba_forward(jcfg, jmix, jnp.asarray(x[:, h:]), state=js1)
    np.testing.assert_allclose(np.concatenate([j1, j2], 1), np.asarray(jy),
                               atol=5e-4, rtol=1e-3)
    py, pst = PL.mamba_forward(pcfg, pmix, torch.from_numpy(x))
    p1, ps1 = PL.mamba_forward(pcfg, pmix, torch.from_numpy(x[:, :h]))
    p2, ps2 = PL.mamba_forward(pcfg, pmix, torch.from_numpy(x[:, h:]),
                               state=ps1)
    np.testing.assert_allclose(torch.cat([p1, p2], 1).numpy(), py.numpy(),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=5e-4,
                               rtol=1e-3)
    for k in pst:
        np.testing.assert_allclose(ps2[k].numpy(), pst[k].numpy(),
                                   atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(ps2[k].numpy(), np.asarray(js2[k]),
                                   atol=5e-4, rtol=1e-3)
