"""Plain PyTorch training of a Qwen3 dense decoder (hf:Qwen/Qwen3-1.7B's
architecture), in float32 with TF32 off: the reference a training cell's
first steps are held against.

The model, from the published description: token embedding; per layer
RMSNorm, q / k / v projections, RMSNorm of each head's q and k over the
head dimension, rotary embedding (the halves rotated, base
``rope_theta``), causal grouped-query attention scaled by 1 / sqrt(hd),
the output projection and a residual add, RMSNorm, a SwiGLU MLP and a
residual add; a final RMSNorm and the tied embedding as the output head;
the mean cross-entropy over every position.  Departures: none in the
mathematics; each layer and the loss's sequence blocks are recomputed in
the backward (``torch.utils.checkpoint``) so that float32 fits.

The training step follows a stated recipe: the gradient, optionally the
secure sync's fixed-point round trip (clip, scale to ``frac_bits``,
round half to even, back), clipping to the global norm, then AdamW with
bias corrections, decoupled weight decay on every weight and a linear
warm-up into a cosine schedule.

``low=True`` is the control: every product's operands rounded to
float8 e4m3 (a per-tensor scale to the format's largest value), the
step a later change might take from bf16.
"""
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from chipbench.reference import secagg
from chipbench.traffic import weights

EPS = 1e-6
LOSS_BLOCK = 512           # positions a block of the loss's logits
FP8_MAX = 448.0            # the largest float8 e4m3 value
LAYER_LEAVES = ("input_layernorm", "q_proj", "k_proj", "v_proj", "q_norm",
                "k_norm", "o_proj", "post_attention_layernorm", "gate_proj",
                "up_proj", "down_proj")


class _RoundFP8(torch.autograd.Function):
    """Round to float8 e4m3 at a per-tensor scale; the gradient passes
    through unchanged."""

    @staticmethod
    def forward(ctx, t):
        amax = t.abs().amax().clamp(min=1e-30)
        s = FP8_MAX / amax
        return (t * s).to(torch.float8_e4m3fn).to(t.dtype) / s

    @staticmethod
    def backward(ctx, g):
        return g


def _mm(a, b, low: bool):
    if low:
        a, b = _RoundFP8.apply(a), _RoundFP8.apply(b)
    return a @ b


def _rms(x, w):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * w


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(cfg: dict, low: bool, h, cos, sin, *w):
    (ln1, wq, wk, wv, qn, kn, wo, ln2, wg, wu, wd) = w
    B, S, _ = h.shape
    H, K, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    a = _rms(h, ln1)
    q = _rms(_mm(a, wq, low).view(B, S, H, hd), qn)
    k = _rms(_mm(a, wk, low).view(B, S, K, hd), kn)
    v = _mm(a, wv, low).view(B, S, K, hd)
    q = _rope(q, cos, sin).transpose(1, 2)                # (B, H, S, hd)
    k = _rope(k, cos, sin).transpose(1, 2).repeat_interleave(H // K, dim=1)
    v = v.transpose(1, 2).repeat_interleave(H // K, dim=1)
    s = _mm(q, k.transpose(-1, -2), low) / math.sqrt(hd)
    causal = torch.ones((S, S), dtype=torch.bool, device=h.device).triu(1)
    p = torch.softmax(s.masked_fill(causal, float("-inf")), dim=-1)
    o = _mm(p, v, low).transpose(1, 2).reshape(B, S, H * hd)
    h = h + _mm(o, wo, low)
    m = _rms(h, ln2)
    return h + _mm(F.silu(_mm(m, wg, low)) * _mm(m, wu, low), wd, low)


def _ce_block(low: bool, h, table, labels):
    logits = _mm(h, table.T, low)
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, labels[..., None].long())[..., 0]).sum()


def loss_fn(cfg: dict, w: dict, batch: dict, low: bool = False):
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    half = cfg["head_dim"] // 2
    inv = torch.exp(-math.log(cfg["rope_theta"]) * torch.arange(
        half, dtype=torch.float32, device=tokens.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=tokens.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    h = w["embed_tokens"][tokens.long()]
    for i in range(cfg["num_hidden_layers"]):
        lw = [w[f"layers.{i}.{k}"] for k in LAYER_LEAVES]
        h = checkpoint(_layer, cfg, low, h, cos, sin, *lw,
                       use_reentrant=False)
    h = _rms(h, w["norm"])
    total = 0.0
    for s0 in range(0, S, LOSS_BLOCK):
        total = total + checkpoint(
            _ce_block, low, h[:, s0:s0 + LOSS_BLOCK], w["embed_tokens"],
            labels[:, s0:s0 + LOSS_BLOCK], use_reentrant=False)
    return total / (B * S)


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then cosine down to
    ``min_lr_frac`` of it at ``total_steps``."""
    warm = min((step + 1) / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) \
        * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def train_readings(cfg: dict, seed: int, batches: list, device, *,
                   secure: bool, steps: int = 3, low: bool = False,
                   rows: slice = slice(None)) -> dict:
    """Train ``steps`` steps from the seed's weights on ``batches`` and
    return {"loss": each step's loss, "grad": each weight's norm of the
    first gradient as the optimizer takes it (with ``secure``, after the
    sync's round trip; clipped),
    "change": each weight's norm of its change over the steps}.
    ``rows`` takes part of every batch (a fault's half batch)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(cfg, seed, batches, device, steps, low, rows, secure)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _train(cfg, seed, batches, device, steps, low, rows, secure) -> dict:
    tr = cfg["training"]
    opt, sync = tr["optimizer"], tr["sync"] if secure else None
    b1, b2 = opt["betas"]
    w = weights.named(cfg, seed, device)
    names = list(w)
    p0 = {k: t.clone() for k, t in w.items()}
    m = {k: torch.zeros_like(t) for k, t in w.items()}
    v = {k: torch.zeros_like(t) for k, t in w.items()}
    if sync is not None:
        scale = secagg.scale_of(sync["parties"], sync["clip"],
                                sync["guard_bits"])
        s32 = torch.tensor(scale, dtype=torch.float32, device=device)
    losses, first = [], None
    for step in range(steps):
        batch = {k: t[rows] for k, t in batches[step].items()}
        leaves = [w[k].requires_grad_(True) for k in names]
        with torch.enable_grad():
            loss = loss_fn(cfg, w, batch, low)
            grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            grads = list(grads)
            if sync is not None:     # the parties' fixed-point round trip
                grads = [secagg.quantize(g, sync["clip"], scale)
                         .to(torch.float32) / s32 for g in grads]
            gnorm = math.sqrt(sum(_norm(g) ** 2 for g in grads))
            clip = min(1.0, opt["grad_clip"] / (gnorm + 1e-9))
            if first is None:
                first = {k: _norm(g) * clip for k, g in zip(names, grads)}
            lr = lr_at(opt, step)
            c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
            for k, g in zip(names, grads):
                g = g * clip
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[k] / c1) / ((v[k] / c2).sqrt() + opt["eps"])
                w[k].sub_(lr * (upd + opt["weight_decay"] * w[k]))
            del grads
    change = {k: _norm(w[k] - p0[k]) for k in names}
    return {"loss": losses, "grad": first, "change": change}
