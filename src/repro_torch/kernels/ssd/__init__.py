"""Mamba2 SSD scan and its backward: CUDA kernels (``csrc/ssd.cu``,
``csrc/ssd_bwd.cu``) beside their plain torch versions."""
from repro_torch.kernels.ssd.ref import (ssd_chunked_bwd_ref,
                                         ssd_chunked_ref, ssd_ref)
from repro_torch.kernels.ssd.ssd import ssd, ssd_chunked
