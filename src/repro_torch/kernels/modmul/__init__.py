"""Batched Montgomery multiplication and modular exponentiation: the
CUDA kernel ``mm_mont_mul`` (``csrc/modmul.cu``) beside its plain torch
version -- the threshold-decryption hot loop."""
from repro_torch.kernels.modmul.modmul import mont_mul_block
from repro_torch.kernels.modmul.ops import (modexp_ints, mont_exp_op,
                                            mont_mul_op)
from repro_torch.kernels.modmul.ref import mont_mul_int, mont_mul_ref
