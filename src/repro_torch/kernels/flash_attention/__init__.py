"""Flash attention: a CUDA kernel (``csrc/flash_attention.cu``) beside its
plain torch version."""
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
