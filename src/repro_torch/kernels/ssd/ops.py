"""Launch of the CUDA SSD scan (``csrc/ssd.cu``) and its backward
(``csrc/ssd_bwd.cu``).

One launcher each serves both layouts the port calls them with: the
Pallas kernel's per-head ``(BH, S, P)`` tensors (``H = 1``: each bh its
own B and C) and the Mamba2 model's ``(batch, S, heads, P)`` activations
with B and C ``(batch, S, N)`` shared by the heads of a batch row.  A
wrapper checks device, dtype, shape and contiguity, allocates its
outputs and the kernels' scratch with ``torch.empty``, launches on the
current stream, raises on a non-zero launch status and counts one call
on :data:`repro_torch.kernels.backend.SSD` (the scan: four kernels) or
:data:`~repro_torch.kernels.backend.SSD_BWD` (the backward: nine).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.backend import SSD, SSD_BWD

HEAD_DIMS = (16, 32, 64)           # the kernel's instantiations of P
MAX_STATE = 128                    # largest N it takes
CHUNK = 256                        # the kernel's chunk (Q in csrc/ssd.cu)
MAX_BWD_HEADS = 512                # MAX_BWD_H in csrc/ssd_bwd.cu

# the launcher's own argument checks, by status
_REFUSED = {1001: f"head dim P is not one of {HEAD_DIMS}",
            1002: f"d_state N is outside 1..{MAX_STATE}",
            1003: "an empty batch or sequence",
            1004: "the heads do not divide the rows",
            1005: f"the chunk is not the kernel's {CHUNK}",
            1006: "more chunks or rows than a grid dimension holds",
            1007: "a state-shaped input is not 16-byte aligned",
            1008: f"more than {MAX_BWD_HEADS} heads (the backward's tables)"}


def _check_all(named: dict, ndims: dict) -> torch.device:
    dev = None
    for name, t in named.items():
        backend.check_tensor(t, torch.float32, ndims[name], name)
        if dev is not None and t.device != dev:
            raise ValueError("the SSD inputs must be on one device")
        dev = t.device
    return dev


def _check_shapes(x, dt, a, Bm, Cm, **more) -> tuple[int, int, int, int,
                                                     int]:
    """(B, S, H, P, N) of the model's layout; ``more`` names tensors that
    must have x's shape ("x") or the state's ("state")."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    want = {"x": tuple(x.shape), "state": (Bsz * H, P, N)}
    if dt.shape != (Bsz, S, H) or a.shape != (Bsz * H,) \
            or Bm.shape != (Bsz, S, N) or Cm.shape != Bm.shape or any(
                t is not None and tuple(t.shape) != want[kind]
                for t, kind in more.values()):
        raise ValueError(
            f"SSD shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a {tuple(a.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}"
            + "".join(f", {n} {tuple(t.shape)}" for n, (t, _) in
                      more.items() if t is not None))
    return Bsz, S, H, P, N


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _strides(S: int, H: int, P: int, N: int) -> tuple:
    """x (b, h, s), dt (b, h, s) and B / C (b, s) strides of the model's
    contiguous layout."""
    return S * H * P, P, H * P, S * H, 1, H, S * N, N


def _fwd_scratch(Bsz: int, H: int, S: int, P: int, N: int) -> dict:
    """The forward's float32 scratch by name, shape, in the order
    ``ssd_scan`` takes it: cum (B H, c, Q), C B^T (B, c, Q, Q) and the
    chunk states (B H, c, P, N), c = ceil(S / Q)."""
    nc = -(-S // CHUNK)
    return {"cum": (Bsz * H, nc, CHUNK), "cb": (Bsz, nc, CHUNK, CHUNK),
            "states": (Bsz * H, nc, P, N)}


def bwd_scratch(Bsz: int, H: int, S: int, P: int, N: int) -> dict:
    """The backward's float32 scratch by name, shape, in the order
    ``ssd_bwd`` takes it: the forward's (the states entering each chunk)
    and the final state, run again; the gradients of the states leaving
    each chunk (B H, c, P, N); M, the head-summed dt E o dy x^T, once per
    batch row and chunk (B, c, Q, Q); dcum and x . r per row (B H, c,
    Q)."""
    nc = -(-S // CHUNK)
    BH = Bsz * H
    return {**_fwd_scratch(Bsz, H, S, P, N), "hfin": (BH, P, N),
            "gstates": (BH, nc, P, N), "mcb": (Bsz, nc, CHUNK, CHUNK),
            "dcum": (BH, nc, CHUNK), "xr": (BH, nc, CHUNK)}


def _alloc(shapes: dict, dev) -> list[torch.Tensor]:
    return [torch.empty(shape, dtype=torch.float32, device=dev)
            for shape in shapes.values()]


def bwd_scratch_bytes(Bsz: int, H: int, S: int, P: int, N: int) -> int:
    """Bytes of :func:`bwd_scratch`."""
    return 4 * sum(math.prod(shape) for shape in
                   bwd_scratch(Bsz, H, S, P, N).values())


def ssd_cuda_heads(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The model's layout: x (B, S, H, P), dt (B, S, H), a (B * H,) with
    row b * H + h, Bm/Cm (B, S, N) shared by the H heads, h0 (B * H, P, N)
    the initial state or None for zero -> y (B, S, H, P) and the final
    state (B * H, P, N)."""
    named = {"x": x, "dt": dt, "a": a, "Bm": Bm, "Cm": Cm, "h0": h0}
    dev = _check_all({k: t for k, t in named.items() if t is not None},
                     {"x": 4, "dt": 3, "a": 1, "Bm": 3, "Cm": 3, "h0": 3})
    Bsz, S, H, P, N = _check_shapes(x, dt, a, Bm, Cm, h0=(h0, "state"))
    y = torch.empty_like(x)
    state = torch.empty((Bsz * H, P, N), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, (state.zero_() if h0 is None else state.copy_(h0))
    cum, cb, states = _alloc(_fwd_scratch(Bsz, H, S, P, N), dev)
    with torch.cuda.device(dev):
        rc = build.lib().ssd_scan(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), _ptr(h0), y.data_ptr(), state.data_ptr(),
            cum.data_ptr(), cb.data_ptr(), states.data_ptr(), Bsz * H, H, S,
            P, N, CHUNK, *_strides(S, H, P, N), backend.stream(dev))
    backend.raise_on(rc, SSD.name, _REFUSED)
    SSD.launches += 1
    return y, state


def ssd_bwd_cuda_heads(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor,
                       h0: Optional[torch.Tensor], y: torch.Tensor,
                       dy: torch.Tensor, dstate: Optional[torch.Tensor]
                       ) -> tuple:
    """The backward in the model's layout: the forward's inputs (h0 None
    for a zero initial state), its output y, dy (B, S, H, P) and the final
    state's gradient dstate (B * H, P, N; None for zero) -> dx, ddt, da
    (B * H,), dB, dC and dinit (B * H, P, N; None when h0 is).

    The scratch is :func:`bwd_scratch`'s: nothing of it is per head and
    Q x Q or S x N."""
    named = {"x": x, "dt": dt, "a": a, "Bm": Bm, "Cm": Cm, "h0": h0,
             "y": y, "dy": dy, "dstate": dstate}
    dev = _check_all({k: t for k, t in named.items() if t is not None},
                     {"x": 4, "dt": 3, "a": 1, "Bm": 3, "Cm": 3, "h0": 3,
                      "y": 4, "dy": 4, "dstate": 3})
    Bsz, S, H, P, N = _check_shapes(
        x, dt, a, Bm, Cm, h0=(h0, "state"), y=(y, "x"), dy=(dy, "x"),
        dstate=(dstate, "state"))
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    da = torch.empty_like(a)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dinit = None if h0 is None else torch.empty_like(h0)
    if x.numel() == 0:
        for t in (dx, ddt, da, dB, dC, dinit):
            if t is not None:
                t.zero_()
        if dinit is not None and dstate is not None:
            dinit.copy_(dstate)
        return dx, ddt, da, dB, dC, dinit
    scratch = _alloc(bwd_scratch(Bsz, H, S, P, N), dev)
    with torch.cuda.device(dev):
        rc = build.lib().ssd_bwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), _ptr(h0), y.data_ptr(), dy.data_ptr(),
            _ptr(dstate), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), _ptr(dinit),
            *(t.data_ptr() for t in scratch), Bsz * H, H, S, P, N, CHUNK,
            *_strides(S, H, P, N), backend.stream(dev))
    backend.raise_on(rc, SSD_BWD.name, _REFUSED)
    SSD_BWD.launches += 1
    return dx, ddt, da, dB, dC, dinit
