"""Launch of the CUDA SSD scan (``csrc/ssd.cu``).

One launcher serves both layouts the port calls it with: the Pallas
kernel's per-head ``(BH, S, P)`` tensors (``H = 1``: each bh its own B and
C) and the Mamba2 model's ``(batch, S, heads, P)`` activations with B and
C ``(batch, S, N)`` shared by the heads of a batch row.  The wrapper
checks device, dtype, shape and contiguity, allocates y, the final state
and the kernels' scratch (the chunks' cumulative decay, C B^T once per
batch row and chunk, the chunk states) with ``torch.empty``, launches the
scan's four kernels on the current stream, raises on a non-zero launch
status and counts one call on :data:`repro_torch.kernels.backend.SSD`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.backend import SSD

HEAD_DIMS = (16, 32, 64)           # the kernel's instantiations of P
MAX_STATE = 128                    # largest N it takes
CHUNK = 256                        # the kernel's chunk (Q in csrc/ssd.cu)

# the launcher's own argument checks, by status
_REFUSED = {1001: f"head dim P is not one of {HEAD_DIMS}",
            1002: f"d_state N is outside 1..{MAX_STATE}",
            1003: "an empty batch or sequence",
            1004: "the heads do not divide the rows",
            1005: f"the chunk is not the kernel's {CHUNK}",
            1006: "more chunks or rows than a grid dimension holds"}


def _check_all(named: dict, ndims: dict) -> torch.device:
    dev = None
    for name, t in named.items():
        backend.check_tensor(t, torch.float32, ndims[name], name)
        if dev is not None and t.device != dev:
            raise ValueError("the SSD inputs must be on one device")
        dev = t.device
    return dev


def ssd_cuda_heads(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The model's layout: x (B, S, H, P), dt (B, S, H), a (B * H,) with
    row b * H + h, Bm/Cm (B, S, N) shared by the H heads -> y (B, S, H, P)
    and the final state (B * H, P, N)."""
    dev = _check_all({"x": x, "dt": dt, "a": a, "Bm": Bm, "Cm": Cm},
                     {"x": 4, "dt": 3, "a": 1, "Bm": 3, "Cm": 3})
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (Bsz, S, H) or a.shape != (Bsz * H,) \
            or Bm.shape != (Bsz, S, N) or Cm.shape != Bm.shape:
        raise ValueError(
            f"SSD shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a {tuple(a.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    y = torch.empty_like(x)
    state = torch.empty((Bsz * H, P, N), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, state.zero_()
    nc = -(-S // CHUNK)
    f32 = dict(dtype=torch.float32, device=dev)
    cum = torch.empty((Bsz * H, nc, CHUNK), **f32)
    cb = torch.empty((Bsz, nc, CHUNK, CHUNK), **f32)
    states = torch.empty((Bsz * H, nc, P, N), **f32)
    with torch.cuda.device(dev):
        rc = build.lib().ssd_scan(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(), cum.data_ptr(),
            cb.data_ptr(), states.data_ptr(), Bsz * H, H, S, P, N, CHUNK,
            S * H * P, P, H * P, S * H, 1, H, S * N, N, backend.stream(dev))
    backend.raise_on(rc, SSD.name, _REFUSED)
    SSD.launches += 1
    return y, state
