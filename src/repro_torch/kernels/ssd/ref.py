"""Plain torch versions of the SSD scan.

Two torch copies of the reference's plain SSD code:

* :func:`ssd_ref`, of the oracle ``repro/kernels/ssd/ref.py:12``: the
  naive sequential recurrence, one step a position (for the tests)

      h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t B_t^T     (P x N)
      y_t = h_t C_t

* :func:`ssd_chunked_ref`, of the Mamba2 model's ``layers.ssd_chunked``
  (``repro/models/layers.py:709-771``): the chunked state-space-dual
  form in the model's layout, from a zero or a carried state, which the
  model runs on the CPU and which ``chip_smoke.py`` holds the CUDA
  kernel against on the card.

and the backward of the chunked form, :func:`ssd_chunked_bwd_ref`,
written out chunk by chunk (the reference has no custom VJP: JAX
differentiates its jnp ``ssd_chunked``).  It is the plain version beside
``csrc/ssd_bwd.cu`` and computes what the kernel computes, in the same
passes.
"""
from __future__ import annotations

from typing import Optional

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (BH, S, P), dt (BH, S), a (BH,), Bm/Cm (BH, S, N) -> y (BH, S, P)
    in x's dtype and the final state (BH, P, N) in float32."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, af = x.float(), dt.float(), a.float()
    Bf, Cf = Bm.float(), Cm.float()
    h = torch.zeros((BH, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * af)[:, None, None]
        h = decay * h + dtf[:, t, None, None] * (xf[:, t, :, None]
                                                 * Bf[:, t, None, :])
        ys.append(torch.einsum("bpn,bn->bp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((BH, 0, P))
    return y.to(x.dtype), h


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., q) -> (..., q, q) lower-triangular sums sum_{j<k<=i} x_k,
    -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                    init_state: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD forward, chunked, from ``init_state`` (B, H, P, N), or from a
    zero state when it is None.

    x:  (B, S, H, P) inputs per head
    dt: (B, S, H)    positive step sizes
    A:  (H,), (B, H) or (B * H,) negative decay rates
    Bm: (B, S, N)    input matrix (shared across heads)
    Cm: (B, S, N)    output matrix
    Returns y: (B, S, H, P), final_state: (B, H, P, N).
    """
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    S_orig = S
    if S % chunk:  # pad with dt=0 steps (decay 1, zero input: exact no-op)
        pad = chunk - S % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // chunk
    xc = x.reshape(Bsz, nc, chunk, H, Pd)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)

    A = A.reshape(-1, H)                                   # (1 or B, H)
    dA = dtc * A[:, None, None, :]                         # (B,c,q,H)
    dA_cum = torch.cumsum(dA, dim=2)
    xdt = xc * dtc[..., None]

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))         # (B,c,H,q,q)
    scores = torch.einsum("bcqn,bctn->bcqt", Cc, Bc)       # (B,c,q,t)
    y_diag = torch.einsum("bchqt,bcqt,bcthp->bcqhp", L, scores, xdt)

    # 2. chunk states
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)   # (B,c,q,H)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc, decay_states, xdt)

    # 3. inter-chunk recurrence over c, emitting the state *before* a chunk
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])           # (B,c,H)
    carry = (torch.zeros((Bsz, H, Pd, N), dtype=x.dtype, device=x.device)
             if init_state is None else init_state.to(x.dtype))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (B,c,H,P,N)

    # 4. state -> output within chunk
    state_decay = torch.exp(dA_cum)                        # (B,c,q,H)
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, state_decay,
                         prev_states)

    y = (y_diag + y_off).reshape(Bsz, S, H, Pd)[:, :S_orig]
    return y, carry


def ssd_dcb_grads(xc: torch.Tensor, dyc: torch.Tensor, dtc: torch.Tensor,
                  E: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                  to_end: torch.Tensor, ecum: torch.Tensor,
                  gh: torch.Tensor, h_prev: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """dB and dC of a chunk in the dCB form of the Mamba2 paper
    (arXiv:2405.21060 section 7; the public mamba_ssm package's
    ``chunk_scan_bwd_dcb``): B and C are shared by the heads of a batch
    row, so the head sums come first.  With D^h_ts = dy^h_t . x^h_s,

        M_ts = sum_h dt^h_s E^h_ts D^h_ts     (one q x q a row and chunk)
        dB_s = sum_t M_ts C_t + sum_(h,p) dt^h_s to_end^h_s x^h_sp gh^h[p]
        dC_t = sum_s M_ts B_s + sum_(h,p) ecum^h_t dy^h_tp h_prev^h[p]

    xc, dyc (B, c, q, H, P); dtc, to_end = exp(cum_last - cum), ecum =
    exp(cum) (B, c, q, H); E (B, c, t, s, H), zero where t < s; Bc, Cc
    (B, c, q, N); gh, h_prev (B, c, H, P, N) -> dB, dC (B, c, q, N)."""
    D = torch.einsum("bcthp,bcshp->bctsh", dyc, xc)
    M = torch.einsum("bctsh,bcsh->bcts", E * D, dtc)
    dB = torch.einsum("bcts,bctn->bcsn", M, Cc) + torch.einsum(
        "bcshp,bchpn->bcsn", (dtc * to_end)[..., None] * xc, gh)
    dC = torch.einsum("bcts,bcsn->bctn", M, Bc) + torch.einsum(
        "bcthp,bchpn->bctn", ecum[..., None] * dyc, h_prev)
    return dB, dC


def ssd_chunked_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                        init_state: Optional[torch.Tensor],
                        dy: torch.Tensor,
                        dstate_final: Optional[torch.Tensor]) -> tuple:
    """The backward of :func:`ssd_chunked_ref`: given dy (B, S, H, P) and
    the gradient of the final state (B, H, P, N; None is zero), returns
    (dx, ddt, dA, dB, dC, dinit) in the shapes of x, dt, A, Bm, Cm and the
    initial state (dinit is None when ``init_state`` is).

    Per chunk c, with cum the in-chunk inclusive cumsum of dt a, G_ts =
    C_t . B_s, E_ts = exp(cum_t - cum_s) for t >= s (0 above), h_{c-1}
    the state entering chunk c (h_{-1} = init_state) and h_c the one
    leaving it:

    1. the reverse state pass: gh_c, the gradient of h_c, from gh_last =
       dstate_final by gh_{c-1} = exp(cum_last) gh_c + u_c, u_c = sum_t
       exp(cum_t) dy_t C_t^T; dinit = gh_{-1};
    2. dx_s = dt_s r_s, r_s = sum_{t>=s} E_ts G_ts dy_t + exp(cum_last -
       cum_s) gh_c B_s;
    3. with D_ts = dy_t . x_s, summed over the heads of a batch row:
       dB_s = dt_s [sum_{t>=s} E_ts D_ts C_t + exp(cum_last - cum_s)
       gh_c^T x_s] and dC_t = sum_{s<=t} E_ts dt_s D_ts B_s + exp(cum_t)
       h_{c-1}^T dy_t, in the head-summed form of
       :func:`ssd_dcb_grads`;
    4. dcum_t = dy_t . y_t - dt_t (x_t . r_t), and at the chunk's last row
       also <gh_c, h_c>: every term of y_t carries exp(cum_t), every term
       of r_s exp(-cum_s), and h_c = exp(cum_last) h_{c-1} + s_c.  Since
       cum_t = a sum_{s<=t} dt_s, with rev the in-chunk reverse cumsum of
       dcum: ddt_s = x_s . r_s + a rev_s and da = sum_s dt_s rev_s.

    x . r is taken before the multiply by dt, so nothing divides by dt
    (the padded rows and a ragged tail have dt = 0)."""
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    S_orig = S
    pad = -S % chunk
    if pad:
        fpad = torch.nn.functional.pad
        x, dy = (fpad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
        dt = fpad(dt, (0, 0, 0, pad))
        Bm, Cm = (fpad(t, (0, 0, 0, pad)) for t in (Bm, Cm))
        S += pad
    nc = S // chunk
    xc = x.reshape(Bsz, nc, chunk, H, Pd)
    dyc = dy.reshape(Bsz, nc, chunk, H, Pd).to(x.dtype)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)
    a = A.reshape(-1, H)                                   # (1 or B, H)
    cum = torch.cumsum(dtc * a[:, None, None, :], dim=2)   # (B,c,q,H)
    last = cum[:, :, -1]                                   # (B,c,H)
    low = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[..., None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,c,t,s,H)
    E = torch.exp(seg.masked_fill(~low, float("-inf")))
    G = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    to_end = torch.exp(last[:, :, None] - cum)             # (B,c,q,H)

    # the forward's states: h_{c-1} entering each chunk, h_c leaving it
    s_c = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bc, to_end * dtc, xc)
    h = (torch.zeros((Bsz, H, Pd, N), dtype=x.dtype, device=x.device)
         if init_state is None else init_state.to(x.dtype))
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * torch.exp(last[:, c])[..., None, None] + s_c[:, c]
    h_prev = torch.stack(entering, dim=1)                  # (B,c,H,P,N)
    h_next = torch.stack(entering[1:] + [h], dim=1)

    # 1. the reverse state pass
    u = torch.einsum("bctn,bcth,bcthp->bchpn", Cc, torch.exp(cum), dyc)
    g = (torch.zeros_like(h) if dstate_final is None
         else dstate_final.to(x.dtype))
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = g
        g = g * torch.exp(last[:, c])[..., None, None] + u[:, c]
    gh = torch.stack(leaving, dim=1)                       # (B,c,H,P,N)

    # 2. dx, through r before the multiply by dt
    r = torch.einsum("bctsh,bcts,bcthp->bcshp", E, G, dyc) + \
        torch.einsum("bcsh,bcsn,bchpn->bcshp", to_end, Bc, gh)
    dx = r * dtc[..., None]
    direct = (xc * r).sum(-1)                              # (B,c,s,H)

    # 3. dB and dC, the heads summed first
    dB, dC = ssd_dcb_grads(xc, dyc, dtc, E, Bc, Cc, to_end, torch.exp(cum),
                           gh, h_prev)

    # 4. dcum, then ddt and da through the reverse cumsum
    y = torch.einsum("bctsh,bcts,bcsh,bcshp->bcthp", E, G, dtc, xc) + \
        torch.einsum("bctn,bcth,bchpn->bcthp", Cc, torch.exp(cum), h_prev)
    dcum = (dyc * y).sum(-1) - dtc * direct
    dcum[:, :, -1] += (gh * h_next).sum((-1, -2))
    rev = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = direct + a[:, None, None, :] * rev
    da = (dtc * rev).sum((1, 2))                           # (B, H)
    if a.shape[0] == 1 and Bsz > 1:
        da = da.sum(0, keepdim=True)

    def unchunk(t, *tail):
        return t.reshape(Bsz, S, *tail)[:, :S_orig]

    return (unchunk(dx, H, Pd), unchunk(ddt, H), da.reshape(A.shape),
            unchunk(dB, N), unchunk(dC, N),
            None if init_state is None else g)
