"""Plain torch versions of the SSD scan.

Two torch copies of the reference's plain SSD code:

* :func:`ssd_ref`, of the oracle ``repro/kernels/ssd/ref.py:12``: the
  naive sequential recurrence, one step a position (for the tests)

      h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t B_t^T     (P x N)
      y_t = h_t C_t

* :func:`ssd_chunked_ref`, of the Mamba2 model's ``layers.ssd_chunked``
  (``repro/models/layers.py:709-771``): the chunked state-space-dual
  form in the model's layout, which the model runs on the CPU and which
  ``chip_smoke.py`` holds the CUDA kernel against on the card.
"""
from __future__ import annotations

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
                    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD forward, chunked, from a zero state.

    x:  (B, S, H, P) inputs per head
    dt: (B, S, H)    positive step sizes
    A:  (H,) or (B, H) negative decay rates
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
    carry = torch.zeros((Bsz, H, Pd, N), dtype=x.dtype, device=x.device)
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
