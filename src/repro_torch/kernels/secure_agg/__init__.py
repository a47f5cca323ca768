"""Secure-aggregation kernels: mask/encrypt, unmask/decrypt and vote as
CUDA kernels (``csrc/secure_agg.cu``) beside their plain versions."""
from repro_torch.kernels.secure_agg.ops import (mask_encrypt_batch_fn,
                                                mask_encrypt_fn,
                                                unmask_decrypt_batch_fn,
                                                unmask_decrypt_fn,
                                                vote_combine_batch_fn,
                                                vote_combine_fn)
from repro_torch.kernels.secure_agg.ref import (mask_encrypt_batch_ref,
                                                mask_encrypt_ref,
                                                unmask_decrypt_batch_ref,
                                                unmask_decrypt_ref,
                                                vote_combine_ref)
from repro_torch.kernels.secure_agg.secure_agg import (PAIRWISE_KEY_BASE,
                                                       pad_stream,
                                                       pairwise_total,
                                                       splitmix32)
