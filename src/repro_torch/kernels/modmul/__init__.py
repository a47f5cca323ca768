"""Batched Montgomery multiplication and modular exponentiation: the
CUDA kernels ``mm_mont_mul`` (one product) and ``mm_mont_exp`` (the whole
square-and-multiply ladder) in ``csrc/modmul.cu`` beside their plain
torch versions -- the threshold-decryption hot loop."""
from repro_torch.kernels.modmul.modmul import mont_mul_block
from repro_torch.kernels.modmul.ops import (modexp_ints, mont_exp_loop,
                                            mont_exp_op, mont_mul_op)
from repro_torch.kernels.modmul.ref import mont_mul_int, mont_mul_ref
