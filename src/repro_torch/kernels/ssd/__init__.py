"""Mamba2 SSD scan: a CUDA kernel (``csrc/ssd.cu``) beside its plain torch
versions."""
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_ref
from repro_torch.kernels.ssd.ssd import ssd, ssd_chunked
