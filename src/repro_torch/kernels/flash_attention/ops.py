"""Launch of the CUDA flash attention kernels.

Forward (``csrc/flash_attention.cu``): bf16 inputs run the tensor-core
kernel (wgmma, tiles by TMA), float32 inputs the CUDA-core kernel; with
``lse=True`` either also writes the float32 row log-sum-exp the backward
reads.  Backward (``csrc/flash_attention_bwd.cu``): the FlashAttention-2
backward as delta, a dK / dV pass a kv tile and a dQ pass a query tile,
each sum in one fixed order in registers (no workspace, no atomics), so
it is deterministic.  bf16 inputs run every product on the tensor cores
(wgmma, tiles by TMA), P and dS entering theirs as bf16 pairs hi + lo;
float32 inputs run the same passes on the CUDA cores in float32.  The
forward and the backward take head dims 16, 32, 64, 80 and 128 (hd 80
as five 16-column panels, from the unpadded tensors).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on the current stream,
raises on a non-zero launch status and counts the launch on
:data:`repro_torch.kernels.backend.FLASH_ATTENTION` or
:data:`~repro_torch.kernels.backend.FLASH_ATTENTION_BWD`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.backend import FLASH_ATTENTION, FLASH_ATTENTION_BWD

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' instantiations: the forward's and the backward's
HEAD_DIMS = (16, 32, 64, 80, 128)
BWD_HEAD_DIMS = (16, 32, 64, 80, 128)

# the launcher's own argument checks, by status
_REFUSED = {1001: "head_dim is not one of the kernel's instantiations "
                  f"{HEAD_DIMS}",
            1002: "n_heads is not a multiple of n_kv_heads",
            1003: "the grid does not fit (B * H, the query or key tiles)",
            1004: "a pointer is not 16-byte aligned (the kernels read "
                  "16-byte vectors and TMA boxes)",
            1005: "the driver offers no cuTensorMapEncodeTiled",
            1006: "cuTensorMapEncodeTiled refused a tensor map"}
_REFUSED_BWD = {**_REFUSED,
                1001: "head_dim is not one of the backward kernel's "
                      f"instantiations {BWD_HEAD_DIMS}"}


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int) -> None:
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    backend.check_tensor(q, q.dtype, 4, "q")
    backend.check_tensor(k, q.dtype, 4, "k")
    backend.check_tensor(v, q.dtype, 4, "v")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must be on one device")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if k.shape[1] == 0 and q.numel():
        raise ValueError("attention over an empty key sequence")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int, lse: bool = False):
    """The output (B, Sq, H, hd) in q's dtype; with ``lse``, the pair
    (output, float32 row log-sum-exp (B, H, Sq))."""
    _check_qkv(q, k, v, window)
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    dev = q.device
    out = torch.empty_like(q)
    L = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev) if lse
         else None)
    if out.numel():
        with torch.cuda.device(dev):
            rc = build.lib().fa_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if L is None else L.data_ptr(), B, H, K, Sq, Skv, hd,
                int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
                DTYPES[q.dtype], backend.stream(dev))
        backend.raise_on(rc, FLASH_ATTENTION.name, _REFUSED)
        FLASH_ATTENTION.launches += 1
    return (out, L) if lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, L: torch.Tensor,
                             causal: bool, window: int
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype from the forward's output ``o``
    and row log-sum-exp ``L``; dq with respect to the unscaled q.  Three
    launches (delta, dK / dV, dQ), counted as one call; the only scratch
    is delta, float32 (B, H, Sq)."""
    _check_qkv(q, k, v, window)
    backend.check_tensor(o, q.dtype, 4, "o")
    backend.check_tensor(do, q.dtype, 4, "do")
    backend.check_tensor(L, torch.float32, 3, "L")
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    if o.shape != q.shape or do.shape != q.shape or \
            tuple(L.shape) != (B, H, Sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} and L "
                         f"{tuple(L.shape)} do not match q {tuple(q.shape)}")
    dev = q.device
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel():
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = build.lib().fa_flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), L.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, H, K, Sq, Skv, hd,
                int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
                DTYPES[q.dtype], backend.stream(dev))
        backend.raise_on(rc, FLASH_ATTENTION_BWD.name, _REFUSED_BWD)
        FLASH_ATTENTION_BWD.launches += 1
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv
