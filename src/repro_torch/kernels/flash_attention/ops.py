"""Launch of the CUDA flash attention kernels (``csrc/flash_attention.cu``):
bf16 inputs run the tensor-core kernel (wgmma, tiles by TMA), float32
inputs the CUDA-core kernel.

The wrapper checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches on the current stream, raises on a
non-zero launch status and counts the launch on
:data:`repro_torch.kernels.backend.FLASH_ATTENTION`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.backend import FLASH_ATTENTION

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)      # the kernel's instantiations

# the launcher's own argument checks, by status
_REFUSED = {1001: "head_dim is not one of the kernel's instantiations "
                  f"{HEAD_DIMS}",
            1002: "n_heads is not a multiple of n_kv_heads",
            1003: "the grid does not fit (B * H or the query tiles)",
            1004: "a pointer is not 16-byte aligned (the kernels read "
                  "16-byte vectors and TMA boxes)",
            1005: "the driver offers no cuTensorMapEncodeTiled",
            1006: "cuTensorMapEncodeTiled refused a tensor map"}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int) -> torch.Tensor:
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    backend.check_tensor(q, q.dtype, 4, "q")
    backend.check_tensor(k, q.dtype, 4, "k")
    backend.check_tensor(v, q.dtype, 4, "v")
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must be on one device")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    dev = q.device
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Skv == 0:
        raise ValueError("attention over an empty key sequence")
    with torch.cuda.device(dev):
        rc = build.lib().fa_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, K, Sq, Skv, hd, int(bool(causal)), int(window),
            1.0 / math.sqrt(hd), DTYPES[q.dtype], backend.stream(dev))
    backend.raise_on(rc, FLASH_ATTENTION.name, _REFUSED)
    FLASH_ATTENTION.launches += 1
    return out
