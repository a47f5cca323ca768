"""H100 SXM5 80GB constants for the port's roofline model.

These are NVIDIA's datasheet figures for the card, not measurements: the
dry run's terms divided by them are estimates of the least time, and a
card set below its 700 W limit runs slower under load.  (The reference's
TPU v5e constants do not carry over.)
"""

PEAK_FLOPS_BF16 = 989e12      # dense bf16 on the tensor cores, FLOP/s
HBM_BW = 3.35e12              # device memory, bytes/s
HBM_BYTES = 80 * 10 ** 9      # device memory, 80 GB
NVLINK_BW = 450e9             # NVLink 4, bytes/s per direction per GPU
