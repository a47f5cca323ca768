"""The plain secure sum: what every node of the cluster protocol
(arXiv:1107.5419) must end with when every party is honest.

Each node's float32 payload is clipped to [-clip, clip], scaled to fixed
point with ``frac_bits = 31 - (ceil(log2 n) + guard_bits)`` fraction
bits (the scale a float32) and rounded half to even; the integers are
summed exactly (the masks cancel in the protocol, so they play no part
in its result); the sum, as a float32, is divided by the float32 scale.
"""
import math

import torch


def scale_of(n_nodes: int, clip: float, guard_bits: int) -> float:
    head = max(1, math.ceil(math.log2(max(n_nodes, 2)))) + guard_bits
    return float(torch.tensor(2.0 ** (31 - head) / clip,
                              dtype=torch.float32))


def quantize(x: torch.Tensor, clip: float, scale: float) -> torch.Tensor:
    """float32 -> int64 fixed point (clip, scale, round half to even)."""
    c = torch.tensor(clip, dtype=torch.float32, device=x.device)
    s = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return torch.round(torch.clamp(x.float(), -c, c) * s).to(torch.int64)


def exact_sum(xs: torch.Tensor, clip: float, guard_bits: int
              ) -> torch.Tensor:
    """(n, T) payloads -> (T,) the exact sum every node must hold."""
    n = xs.shape[0]
    scale = scale_of(n, clip, guard_bits)
    acc = torch.zeros(xs.shape[1:], dtype=torch.int64, device=xs.device)
    for i in range(n):
        acc += quantize(xs[i], clip, scale)
    s = torch.tensor(scale, dtype=torch.float32, device=xs.device)
    return acc.to(torch.float32) / s


def float_sum(xs: torch.Tensor, clip: float, guard_bits: int
              ) -> torch.Tensor:
    """The control: the same quantized payloads summed in float32, node
    by node, as a plain float allreduce would (no exact integer sum)."""
    n = xs.shape[0]
    scale = scale_of(n, clip, guard_bits)
    s = torch.tensor(scale, dtype=torch.float32, device=xs.device)
    acc = torch.zeros(xs.shape[1:], dtype=torch.float32, device=xs.device)
    for i in range(n):
        acc += quantize(xs[i], clip, scale).to(torch.float32) / s
    return acc
