"""Flash attention: CUDA kernels (``csrc/flash_attention.cu``, the
forward; ``csrc/flash_attention_bwd.cu``, its backward) beside their plain
torch versions."""
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref,
                                                     attention_ref)
