"""Readers that more than one per-layer metric uses: the same quantity
read in cells that report different end-to-end metrics.  Each metric's
own file under ``metrics/`` names the one it reads."""
from chipbench import harness
from chipbench.counts import kernels, model, peaks


def device_idle_share(trace):
    """The share of the traced window in which no operation ran on the
    device."""
    tr = harness.on_card(trace)
    w = tr.trace_window_s()
    if not tr.ops or w <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / w)


def step_mfu(trace):
    """The whole step's share of the card's bf16 peak: the model FLOPs of
    the steps completed in the traced window (6 x params x tokens plus
    causal attention, no recompute) over the window's seconds."""
    tr = harness.on_card(trace)
    if not tr.iters or tr.window_s <= 0:
        return None
    cfg, t = tr.cell.config, tr.cell.traffic
    flops = model.train_step_flops(cfg, t["batch"], t["seq_len"]) * tr.iters
    return 100.0 * flops / tr.window_s / peaks.BF16_FLOPS_PER_S


def flash_fwd_roofline(trace):
    """The flash forward's share of its roofline: each launch's causal
    forward work (bf16 q, k, v, o; the float32 log-sum-exp) at the card's
    peaks, summed over its launches, over their summed profiled time."""
    tr = harness.on_card(trace)
    t, count = tr.op_time(kernels.named(kernels.FLASH_FWD))
    if not count:
        return None
    cfg, tf = tr.cell.config, tr.cell.traffic
    nbytes, flops = model.flash_fwd_work(cfg, tf["batch"], tf["seq_len"])
    return 100.0 * count * peaks.bound_s(nbytes, flops=flops) / t


def flash_bwd_roofline(trace):
    """The flash backward's share of its roofline: each call's causal
    backward work (five products; bf16 q, k, v, o, dO read, dq, dk, dv
    written) at the card's peaks, summed over its calls, over the summed
    profiled time of all the backward's kernels."""
    tr = harness.on_card(trace)
    t, _ = tr.op_time(kernels.named(kernels.FLASH_BWD))
    _, calls = tr.op_time(kernels.named(kernels.FLASH_BWD_CALL))
    if not calls or t <= 0:
        return None
    cfg, tf = tr.cell.config, tr.cell.traffic
    nbytes, flops = model.flash_bwd_work(cfg, tf["batch"], tf["seq_len"])
    return 100.0 * calls * peaks.bound_s(nbytes, flops=flops) / t
