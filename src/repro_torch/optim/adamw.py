"""AdamW with a cosine schedule, global-norm clipping and a configurable
state dtype.

Counterpart of ``repro/optim/adamw.py``, in plain torch: the reference
computes it in jnp outside any Pallas kernel.  Trees are the model's
nested dicts and lists of tensors.  The schedule, the bias corrections
and the clip scale stay 0-d float32 tensors on the parameters' device,
so a step reads nothing back to the host.  The update runs as
``torch._foreach_*`` passes over groups of leaves (a few launches a
pass; each group's float32 temporaries at most ``GROUP_ELEMS``
elements), and writes the parameters and moments **in place** -- at
qwen3-1.7b's width a fresh copy of each would be another 6.9 GB -- where
the reference returns new arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core.engine import tree_flatten

GROUP_ELEMS = 1 << 27      # elements a foreach group: 512 MiB of float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 tensor: linear warm-up, then cosine down to ``min_lr_frac``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(cfg: OptConfig, params: Any) -> dict:
    dt = getattr(torch, cfg.state_dtype)
    leaves, rebuild = tree_flatten(params)

    def zeros():
        return rebuild([torch.zeros(p.shape, dtype=dt, device=p.device)
                        for p in leaves])

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def leaf_squares(tree: Any) -> list:
    """Each leaf's float32 sum of squares, in ``tree_flatten``'s order."""
    return [torch.sum(torch.square(leaf.float()))
            for leaf in tree_flatten(tree)[0]]


def norm_of_squares(squares: list) -> torch.Tensor:
    """sqrt of the sum of ``leaf_squares``, added leaf by leaf in order,
    as the reference."""
    total = squares[0]
    for s in squares[1:]:
        total = total + s
    return torch.sqrt(total)


def global_norm(tree: Any) -> torch.Tensor:
    """The global norm of ``tree``: ``norm_of_squares(leaf_squares)``."""
    return norm_of_squares(leaf_squares(tree))


def _groups(leaves: list) -> list:
    """Consecutive index groups of at most GROUP_ELEMS elements (a larger
    leaf alone)."""
    groups, cur, n = [], [], 0
    for i, leaf in enumerate(leaves):
        if cur and n + leaf.numel() > GROUP_ELEMS:
            groups.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += leaf.numel()
    if cur:
        groups.append(cur)
    return groups


@torch.no_grad()
def apply_updates(cfg: OptConfig, params: Any, grads: Any, state: dict,
                  grad_norm: Optional[torch.Tensor] = None
                  ) -> tuple[Any, dict, dict]:
    """One AdamW step; returns (params, new state, metrics).  ``params``
    and the state's moments are updated in place and returned; the new
    state's ``step`` is a new tensor.  ``grad_norm`` overrides the local
    norm (the secure path's norm of the synced gradients)."""
    p_l, _ = tree_flatten(params)
    g_l, _ = tree_flatten(grads)
    m_l, _ = tree_flatten(state["m"])
    v_l, _ = tree_flatten(state["v"])
    if not len(p_l) == len(g_l) == len(m_l) == len(v_l):
        raise ValueError("params, grads and moments differ in structure")
    step = state["step"]
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.betas
    lr = lr_at(cfg, step)
    t = (step + 1).to(torch.float32)
    bias1 = 1 - b1 ** t
    bias2 = 1 - b2 ** t
    for idx in _groups(p_l):
        p32 = [p_l[i].float() for i in idx]
        g = torch._foreach_mul([g_l[i].float() for i in idx], scale)
        m32 = torch._foreach_mul([m_l[i].float() for i in idx], b1)
        torch._foreach_add_(m32, torch._foreach_mul(g, 1 - b1))
        v32 = torch._foreach_mul([v_l[i].float() for i in idx], b2)
        torch._foreach_add_(v32, torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
        del g
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v32, bias2)),
                             cfg.eps)
        upd = torch._foreach_div(torch._foreach_div(m32, bias1), den)
        del den
        torch._foreach_add_(upd, torch._foreach_mul(p32, cfg.weight_decay))
        newp = torch._foreach_sub(p32, torch._foreach_mul(upd, lr))
        del upd
        for j, i in enumerate(idx):
            p_l[i].copy_(newp[j])
            m_l[i].copy_(m32[j])
            v_l[i].copy_(v32[j])
    new_state = {"m": state["m"], "v": state["v"], "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
