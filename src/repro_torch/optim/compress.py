"""Error-feedback gradient compression, composable with secure
aggregation.

Counterpart of ``repro/optim/compress.py``: before the sync, each
gradient (plus the carried residual) is round-tripped through int8
blocks or top-k, and what compression dropped is kept as the next
step's residual (EF-SGD / EF21), so compression noise does not bias
convergence.  One difference is written out: the reference's
``jnp.clip(jnp.round(x)).astype(int8)`` sends NaN to 0 (XLA's
conversion), where torch's cast of NaN is platform-defined, so NaN is
sent to 0 explicitly before the cast, as the secure kernels' quantizer
does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.engine import tree_flatten


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    kind: str = "none"      # none | int8 | topk
    block: int = 256         # int8 scaling-block size
    topk_frac: float = 0.05


def init_residual(params: Any) -> Any:
    leaves, rebuild = tree_flatten(params)
    return rebuild([torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves])


def _int8_rt(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    fp = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = torch.amax(torch.abs(fp), dim=1, keepdim=True) / 127.0 + 1e-12
    r = torch.clamp(torch.round(fp / scale), -127, 127)
    q = torch.where(torch.isnan(r), torch.zeros_like(r), r).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq.reshape(-1)[: flat.shape[0]].reshape(x.shape)


def _topk_rt(x: torch.Tensor, frac: float) -> torch.Tensor:
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.sort(torch.abs(flat)).values[-k]
    return torch.where(torch.abs(flat) >= thresh, flat,
                       torch.zeros_like(flat)).reshape(x.shape)


def compress_with_feedback(cfg: CompressConfig, grads: Any, residual: Any
                           ) -> tuple[Any, Any, dict]:
    """Returns (compressed grads to aggregate, new residual, metrics)."""
    if cfg.kind == "none":
        return grads, residual, {"compress_ratio": 1.0}
    if cfg.kind not in ("int8", "topk"):
        raise ValueError(cfg.kind)
    g_l, rebuild = tree_flatten(grads)
    r_l, _ = tree_flatten(residual)
    outs, res = [], []
    for g, r in zip(g_l, r_l):
        x = g.float() + r
        rt = (_int8_rt(x, cfg.block) if cfg.kind == "int8"
              else _topk_rt(x, cfg.topk_frac))
        outs.append(rt.to(g.dtype))
        res.append(x - rt)
    ratio = {"int8": 0.25, "topk": cfg.topk_frac * 2}[cfg.kind]
    return rebuild(outs), rebuild(res), {"compress_ratio": ratio}
