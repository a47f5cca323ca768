"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  Shares are taken against these;
each run's card name and power limit are printed beside them."""

HBM_BYTES_PER_S = 3.35e12          # device memory
BF16_FLOPS_PER_S = 989e12          # dense bf16 on the tensor cores
F32_FLOPS_PER_S = 67e12            # float32 FMA outside the tensor cores
# 32-bit lane operations issued a second: 132 SMs x 128 lanes x 1.98 GHz,
# half the float32 FMA rate (an FMA counts two FLOPs)
LANE_OPS_PER_S = F32_FLOPS_PER_S / 2
# 32-bit integer add, logical, shift and multiply: 64 results a clock an
# SM, half the lane rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound_s(nbytes: float, flops: float = 0.0, int_ops: float = 0.0,
            float_ops: float = 0.0) -> float:
    """The least time the card needs: the larger of the bytes over the
    memory rate, tensor-core FLOPs over the bf16 rate, and integer and
    lane operations over their issue rates (integers through their
    half-rate pipe; every lane operation shares the issue rate)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S,
               int_ops / INT32_OPS_PER_S,
               (int_ops + float_ops) / LANE_OPS_PER_S)
