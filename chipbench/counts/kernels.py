"""The port's own CUDA kernels by the names the profiler shows (function
names without namespaces or template arguments): those in
``src/repro_torch/csrc`` when the benchmark was written."""

MASK = ("mask_kernel",)
UNMASK = ("unmask_kernel",)
VOTE = ("vote_kernel",)
FLASH_FWD = ("flash_wgmma_kernel", "flash_kernel")
FLASH_BWD = ("fa_delta_kernel", "fa_dkdv_wgmma_kernel", "fa_dq_wgmma_kernel",
             "fa_bwd_kernel", "fa_dq_kernel")
# one launch each backward call, whichever dtype path runs
FLASH_BWD_CALL = ("fa_delta_kernel",)
PORT = (*MASK, *UNMASK, *VOTE, *FLASH_FWD, *FLASH_BWD, "mont_mul_kernel",
        "mont_exp_kernel", "ssd_scan_kernel", "ssd_cb_kernel",
        "ssd_state_kernel", "ssd_pass_kernel", "ssd_dcb_kernel",
        "ssd_dx_kernel", "ssd_dbdc_kernel", "ssd_finish_kernel")


def named(names) -> callable:
    """A matcher of short kernel names."""
    names = frozenset(names)
    return lambda n: n in names
