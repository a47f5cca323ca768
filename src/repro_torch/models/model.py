"""The port's unified model: init / forward / prefill / decode over the
stack of pattern units (see ``configs.base.ModelConfig``).

Counterpart of ``repro/models/model.py``.  Parameters are nested dicts of
tensors in the reference's layout, except that the reference's
``params["units"]`` leaves carry a leading ``n_units`` axis (its
``init_params`` vmaps the unit init and its forward scans over that
axis), while here ``params["units"]`` is a list of ``n_units`` unit dicts
run by a Python loop; caches likewise.  The reference's ``constrain``
(GSPMD sharding hints) has no counterpart: under a tensor-parallel
context (``runtime.context``) every rank holds its slice of the weights
and the layers call the collectives, the embedding vocab-parallel (a
masked gather of the rank's rows, summed over the axis), the head
vocab-parallel (the rank's columns of the logits: gathered for serving,
left cut for the loss, ``loss_fn``), and every rank of a model slice
holds the same residual stream, bit for bit (each sum over the axis
hands every rank the same bits).  With ``seq_parallel`` (the reference
constrains the stream to ``P(dp, "model", None)`` after every unit) a
rank holds its block of ``S / tp`` positions of the stream between the
mixers and MLPs (the norms and residual adds run there; each mixer and
MLP sees the whole sequence), where ``S`` splits over the ranks and
never in a decode step (``seq_layout``).  ``init_cache`` under
such a context is the rank's: a K / V leaf every KV head at the rank's
block of positions (the reference's ``cache_specs``: cut over
``"model"``, or ``("data", "model")`` where the batch does not split;
``runtime.context.cache_cut``), its SSD heads and ``d_inner`` channels;
the prefill hands each rank its block of the prompt's K / V in one
all-to-all a layer (``_relayout``).  Under an FSDP context
(``fsdp_axis``) a rank's FSDP leaves are slices on their ``d_model``
side: each unit's are
gathered where the unit runs (``_gathered``: in the forward loop inside
the unit's checkpoint, so a remat backward gathers them again; in the
prefill and each decode step), the untied head's in ``lm_head``, so a
rank holds its slices and the unit that runs (without remat autograd
keeps each unit's gathered weights for the backward, as it keeps the
unit's activations).  ``cfg.remat`` runs
each unit of the training forward under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint``).  Every forward and prefill reaches its
kernels through ``impl``: ``None`` picks the CUDA kernel on a CUDA tensor
and the plain version on a CPU tensor, ``"torch"`` the plain version
anywhere.  ``loss_fn`` is the training loss; its gradients come from
autograd, attention's from the flash backward kernel on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import (ATTN_CHUNKED, CROSS_ATTN, DENSE, MAMBA2,
                                      MOE, NONE, ModelConfig)
from repro_torch.core.schedules import ConfigError
from repro_torch.models import layers as L
from repro_torch.runtime.context import (cache_cut, cache_exchange,
                                         fsdp_gather, fsdp_size, get_ctx,
                                         seq_block, seq_cut, tp_copy,
                                         tp_enter, tp_exit, tp_gather,
                                         tp_index, tp_size, use_ctx,
                                         vocab_ce)

Params = Any
Cache = Any

# leaves the reference reads in float32 whatever the compute dtype (the
# MoE router too: its logits, and so the experts picked, come from the
# float32 router); every other leaf it reads only as ``.astype(cfg.dtype)``
F32_LEAVES = ("q_norm", "k_norm", "dt_bias", "A_log", "out_norm", "router")


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 256) * 256


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_unit(cfg: ModelConfig, gen: torch.Generator,
               expert_dtype: torch.dtype = torch.float32) -> dict:
    unit = {}
    for i, spec in enumerate(cfg.pattern):
        lp = {"norm1": L.make_norm_params(cfg, gen)}
        if spec.mixer == MAMBA2:
            lp["mixer"] = L.make_mamba_params(cfg, gen)
        else:
            cross = spec.mixer == CROSS_ATTN
            lp["mixer"] = L.make_attn_params(cfg, gen, cross=cross)
            if cross:
                lp["media_norm"] = L.make_norm_params(cfg, gen)
        if spec.mlp == DENSE:
            lp["norm2"] = L.make_norm_params(cfg, gen)
            lp["mlp"] = L.make_mlp_params(cfg, gen)
        elif spec.mlp == MOE:
            lp["norm2"] = L.make_norm_params(cfg, gen)
            lp["mlp"] = L.make_moe_params(cfg, gen, expert_dtype)
        unit[f"layer{i}"] = lp
    return unit


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                cast: bool = False) -> Params:
    """Random float32 master weights with the reference's stds, drawn from
    ``gen`` on ``gen.device``.  The numbers differ from the reference's
    ``jax.random`` draws for the same seed; a test that needs the same
    weights carries the reference's across (``convert``).  ``cast=True``
    gives ``cast_params(cfg, init_params(cfg, gen))``, the same draws,
    with each piece cast as soon as it is drawn: at most one unit's
    float32 masters (or the float32 table) live at once, and of an MoE
    layer's expert stacks one expert's matrix (each is drawn in float32
    and stored cast), so a model whose weights fit the card only in the
    compute dtype can be served.  An audio-frames model has no embedding
    table (its inputs are frame embeddings) and always its own head.
    ``gen`` may be the ``meta`` device instead of a generator: the
    shapes and dtypes alone, with no draw."""
    keep = (lambda t: cast_params(cfg, t)) if cast else (lambda t: t)
    d = cfg.d_model
    Vp = padded_vocab(cfg)
    audio = cfg.frontend == "audio_frames"
    params: dict = {}
    if not audio:
        params.update(keep({"embed": L._normal(gen, (Vp, d), d ** -0.5)}))
    if not cfg.tie_embeddings or audio:
        params.update(keep({"head": L._normal(gen, (d, Vp), d ** -0.5)}))
    params["final_norm"] = keep(L.make_norm_params(cfg, gen))
    expert_dtype = compute_dtype(cfg) if cast else torch.float32
    params["units"] = [keep(_init_unit(cfg, gen, expert_dtype))
                       for _ in range(cfg.n_units)]
    return params


def cast_params(cfg: ModelConfig, params: Params) -> Params:
    """The weights as the forward reads them: every leaf the reference
    casts to ``cfg.dtype`` at each use is cast once here (the same
    rounding, so the same values), the float32 leaves stay.  Serving calls
    it once instead of casting every weight at every step."""
    dtype = compute_dtype(cfg)

    def go(tree, name=""):
        if isinstance(tree, dict):
            return {k: go(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [go(v) for v in tree]
        return tree if name in F32_LEAVES else tree.to(dtype)

    return go(params)


def _gathered(cfg: ModelConfig, tree: dict, prefix: tuple) -> dict:
    """``tree`` (the subtree at key path ``prefix``) with each FSDP slice
    gathered over the FSDP axis (``runtime.context.fsdp_gather``) in the
    dtype the layers read it in; every other leaf as it is."""
    ctx = get_ctx()
    if fsdp_size(ctx) == 1:
        return tree
    # launch.sharding imports this module: import its rule at call time
    from repro_torch.launch.sharding import fsdp_dim
    dtype = compute_dtype(cfg)

    def go(t, path):
        if isinstance(t, dict):
            return {k: go(v, path + (k,)) for k, v in t.items()}
        d = fsdp_dim(cfg, path, t)
        if d is None:
            return t
        return fsdp_gather(ctx, t, d,
                           t.dtype if path[-1] in F32_LEAVES else dtype)

    return go(tree, prefix)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_inputs(cfg: ModelConfig, params: Params, batch: dict
                 ) -> torch.Tensor:
    """The token embeddings, or an audio model's frames (B, S, D) cast to
    the compute dtype.  Under TP the table holds the rank's block of rows:
    each token's row from the rank that holds it, zeros from the others,
    summed (one nonzero term: the sum is exact) by ``tp_exit``, which
    under ``seq_parallel`` leaves the rank its block of positions (the
    frames: their block)."""
    ctx = get_ctx()
    if cfg.frontend == "audio_frames":
        return seq_block(ctx, batch["frames"].to(compute_dtype(cfg)))
    # gather, then cast: the reference casts the table first, the same
    # values for the rows gathered; the multiplier in the compute dtype
    table, tokens = params["embed"], batch["tokens"]
    if tp_size(ctx) == 1:
        x = table[tokens].to(compute_dtype(cfg))
    else:
        v_loc = table.shape[0]
        local = tokens.long() - tp_index(ctx) * v_loc
        mine = (local >= 0) & (local < v_loc)
        x = table[local.clamp(0, v_loc - 1)].to(compute_dtype(cfg))
        x = tp_exit(ctx, x * mine[..., None].to(x.dtype))
    if cfg.embedding_multiplier != 1.0:
        x = x * L.weak_scalar(cfg.embedding_multiplier, x.dtype)
    return x


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor
            ) -> torch.Tensor:
    """x @ embed^T with tied embeddings (and a table), else x @ head:
    under TP the rank's columns of the logits, of the whole sequence (x
    enters through ``tp_enter``)."""
    x = tp_enter(get_ctx(), x)
    if cfg.tie_embeddings and "embed" in params:
        return x @ params["embed"].to(x.dtype).T
    head = _gathered(cfg, {"head": params["head"]}, ())["head"]
    return x @ head.to(x.dtype)


def lm_head(cfg: ModelConfig, params: Params, x: torch.Tensor
            ) -> torch.Tensor:
    """The logits (B, S, Vp): under TP the rank's columns gathered into
    all Vp on every rank (serving reads the last position's; the loss
    never gathers them: ``loss_fn``)."""
    return tp_gather(get_ctx(), _logits(cfg, params, x))


@contextlib.contextmanager
def seq_layout(S: int, cut: bool = True):
    """The context with the residual stream cut on the sequence where the
    context's ``seq_parallel`` asks for it, ``cut`` allows it and the
    ``S`` positions split over the TP ranks; else not cut.  A sequence
    that does not split (a prompt of 7 tokens at TP 2) runs with the
    stream whole on every rank, the layout without ``seq_parallel``,
    which computes the same values; a decode step's one position is
    never cut."""
    ctx = get_ctx()
    want = cut and ctx.seq_parallel and S % tp_size(ctx) == 0
    if want == ctx.seq_parallel:
        yield
        return
    with use_ctx(dataclasses.replace(ctx, seq_parallel=want)):
        yield


def _norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """A norm of the residual stream: under ``seq_parallel`` on the
    rank's positions, so its scale's gradient is summed over the TP axis
    (``tp_copy``)."""
    ctx = get_ctx()
    if "scale" in p and seq_cut(ctx):
        p = {"scale": tp_copy(ctx, p["scale"])}
    return L.apply_norm(cfg, p, x)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _mlp(cfg: ModelConfig, spec, lp: dict, x: torch.Tensor) -> torch.Tensor:
    if spec.mlp == NONE:
        return x
    h = _norm(cfg, lp["norm2"], x)
    if spec.mlp == MOE:
        return x + L.moe_forward(cfg, lp["mlp"], h)
    return x + L.mlp_forward(cfg, lp["mlp"], h)


def _media(cfg: ModelConfig, batch: dict, x: torch.Tensor
           ) -> Optional[torch.Tensor]:
    """The batch's media embeddings (B, M, D) in x's dtype, if it has
    any."""
    media = batch.get("media")
    return None if media is None else media.to(x.dtype)


def _unit_forward(cfg: ModelConfig, unit: dict, x: torch.Tensor,
                  media: Optional[torch.Tensor],
                  impl: Optional[str]) -> torch.Tensor:
    for i, spec in enumerate(cfg.pattern):
        lp = unit[f"layer{i}"]
        h = _norm(cfg, lp["norm1"], x)
        if spec.mixer == MAMBA2:
            y, _ = L.mamba_forward(cfg, lp["mixer"], h, impl=impl)
        elif spec.mixer == CROSS_ATTN:
            med = L.apply_norm(cfg, lp["media_norm"], media)
            y = L.attn_forward(cfg, lp["mixer"], h, mixer=spec.mixer,
                               media=med, impl=impl)
        else:
            y = L.attn_forward(cfg, lp["mixer"], h, mixer=spec.mixer,
                               impl=impl)
        x = _mlp(cfg, spec, lp, x + y)
    return x


def _unit_run(cfg: ModelConfig, unit: dict, i: int, x: torch.Tensor,
              media: Optional[torch.Tensor], impl: Optional[str], ctx
              ) -> torch.Tensor:
    """Unit ``i``'s forward under ``ctx``, its FSDP slices gathered
    first.  ``ctx`` is the forward's: a remat backward recomputes the
    unit after ``seq_layout`` has exited, in the layout it ran in."""
    with use_ctx(ctx):
        return _unit_forward(cfg, _gathered(cfg, unit, ("units", i)), x,
                             media, impl)


def _hidden(cfg: ModelConfig, params: Params, batch: dict,
            impl: Optional[str]) -> torch.Tensor:
    """The final normed residual stream (the rank's block of positions
    under ``seq_parallel``)."""
    ctx = get_ctx()
    x = embed_inputs(cfg, params, batch)
    media = _media(cfg, batch, x)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, unit in enumerate(params["units"]):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _unit_run, cfg, unit, i, x, media, impl, ctx,
                use_reentrant=False)
        else:
            x = _unit_run(cfg, unit, i, x, media, impl, ctx)
    return _norm(cfg, params["final_norm"], x)


def _seq_len(cfg: ModelConfig, batch: dict) -> int:
    key = "frames" if cfg.frontend == "audio_frames" else "tokens"
    return batch[key].shape[1]


def forward(cfg: ModelConfig, params: Params, batch: dict,
            impl: Optional[str] = None) -> torch.Tensor:
    """Returns logits (B, S, Vp) of ``batch["tokens"]`` (or an audio
    model's ``batch["frames"]``; a cross-attention model also reads
    ``batch["media"]``).  Under autograd with ``cfg.remat`` each
    unit keeps only its input and runs again in the backward pass."""
    with seq_layout(_seq_len(cfg, batch)):
        return lm_head(cfg, params, _hidden(cfg, params, batch, impl))


def loss_fn(cfg: ModelConfig, params: Params, batch: dict,
            total_tokens: Optional[int] = None,
            impl: Optional[str] = None) -> torch.Tensor:
    """Cross-entropy over float32 logits, the padded vocab columns at
    -1e30, positions with ``labels < 0`` masked out, normalized by the
    *global* token count ``total_tokens`` so that the sum of per-replica
    losses and gradients over data-parallel ranks is the global mean (the
    secure sync is then a plain modular sum), else by the local count.
    Under TP the logits stay cut on the vocabulary: each rank holds its
    columns (B, S, Vp / tp) and ``runtime.context.vocab_ce`` reduces over
    the cut (the padded columns found by their global index).  ``impl``
    as ``forward``'s."""
    ctx = get_ctx()
    with seq_layout(_seq_len(cfg, batch)):
        logits = _logits(cfg, params,
                         _hidden(cfg, params, batch, impl)).float()
    labels = batch["labels"]
    V, v_loc = cfg.vocab_size, logits.shape[-1]
    col0 = tp_index(ctx) * v_loc if tp_size(ctx) > 1 else 0
    if col0 + v_loc > V:
        # in place on the float32 copy: the cast's backward keeps nothing
        logits.masked_fill_(torch.arange(col0, col0 + v_loc,
                                         device=logits.device) >= V, -1e30)
    lbl = labels.clamp(0, V - 1).long()
    if tp_size(ctx) > 1:
        ce = vocab_ce(ctx, logits, lbl)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ce = lse - logits.gather(-1, lbl[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = ce * mask
    denom = total_tokens if total_tokens is not None else \
        mask.sum().clamp(min=1.0)
    return ce.sum() / denom


# ---------------------------------------------------------------------------
# KV / SSM caches
# ---------------------------------------------------------------------------


def _cache_block(cfg: ModelConfig, S: int, what: str) -> int:
    """The positions of one block of a K / V leaf of ``S`` positions
    under the context's cut (``S`` where nothing cuts); a length the cut
    does not divide raises ``ConfigError`` (the reference's sharding
    refuses it too)."""
    ctx = get_ctx()
    n, _ = cache_cut(ctx)
    if S % n:
        raise ConfigError(
            f"{cfg.name}: a KV cache of {S} {what} does not split into the "
            f"{n} blocks of its cut over {ctx.cache_axes}")
    return S // n


def _layer_cache(cfg: ModelConfig, spec, B: int, max_seq: int,
                 device, media_len: int = 0) -> dict:
    """One layer's zero cache: a K / V leaf holds every KV head at the
    rank's block of positions (all of them where nothing cuts), a Mamba2
    layer's states the rank's SSD heads and ``d_inner`` channels under a
    TP context."""
    tp = tp_size(get_ctx())
    hd = cfg.hd
    dtype = compute_dtype(cfg)
    if spec.mixer == MAMBA2:
        s = cfg.ssm
        d_in = s.expand * cfg.d_model // tp
        nh = d_in // s.head_dim
        return {
            "conv_x": torch.zeros((B, s.d_conv - 1, d_in), dtype=dtype,
                                  device=device),
            "conv_B": torch.zeros((B, s.d_conv - 1, s.d_state), dtype=dtype,
                                  device=device),
            "conv_C": torch.zeros((B, s.d_conv - 1, s.d_state), dtype=dtype,
                                  device=device),
            "ssd": torch.zeros((B, nh, s.head_dim, s.d_state),
                               dtype=torch.float32, device=device),
        }
    if spec.mixer == CROSS_ATTN:
        S = _cache_block(cfg, media_len, "media tokens")
    elif spec.mixer == ATTN_CHUNKED:
        S = _cache_block(cfg, min(max_seq, cfg.attn_window), "window slots")
    else:
        S = _cache_block(cfg, max_seq, "positions")
    K = cfg.n_kv_heads
    return {"k": torch.zeros((B, S, K, hd), dtype=dtype, device=device),
            "v": torch.zeros((B, S, K, hd), dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, B: int, max_seq: int, device,
               media_len: int = 0) -> Cache:
    """Zero caches: an attention layer's K / V at ``max_seq`` positions
    (a chunked layer's at its window), a cross-attention layer's at
    ``media_len`` media tokens, a Mamba2 layer's conv and SSD states;
    under a mesh's context, this rank's (its block of positions, its SSD
    heads)."""
    return [{f"layer{i}": _layer_cache(cfg, spec, B, max_seq, device,
                                       media_len)
             for i, spec in enumerate(cfg.pattern)}
            for _ in range(cfg.n_units)]


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _relayout(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, Sc: int,
              take: int, what: str) -> dict:
    """This rank's block of a K / V cache of ``Sc`` slots, every KV head,
    from the prompt's k and v (B, S, K_loc, hd) of the rank's own heads:
    slot ``s < take`` holds position ``S - take + s``, the rest are zero
    (a ring buffer's tail at slot 0, as the reference places it).  Rank
    (d, m) of the cut holds block ``j = d tp + m``: each TP rank sends
    each TP peer of its data slice the peer's block of its own heads, in
    one all-to-all (``cache_exchange``); a KV head held by ``span = tp /
    K`` ranks is sent by one of them, the one whose TP index is the
    peer's modulo ``span``.  No rank holds more than its own heads'
    blocks for its slice's peers; at TP 1 the block is a local slice."""
    ctx = get_ctx()
    n, j = cache_cut(ctx)
    Sb = _cache_block(cfg, Sc, what)
    B, S, Kl, hd = k.shape
    tp, m = tp_size(ctx), tp_index(ctx)
    span = max(tp // cfg.n_kv_heads, 1)

    def block(jj: int) -> torch.Tensor:
        out = k.new_zeros((2, B, Sb, Kl, hd))
        a, b = jj * Sb, min((jj + 1) * Sb, take)
        if a < b:
            out[0, :, :b - a] = k[:, S - take + a:S - take + b]
            out[1, :, :b - a] = v[:, S - take + a:S - take + b]
        return out

    if tp == 1:
        kv = block(j)
    else:
        first = j - m       # block of TP rank 0 of this data slice
        sends = [block(first + p) if p % span == m % span else k[:0]
                 for p in range(tp)]
        nbytes = 2 * B * Sb * Kl * hd * k.element_size()
        got = cache_exchange(ctx, sends, [nbytes if p % span == m % span
                                          else 0 for p in range(tp)])
        kv = torch.cat([g.view(k.dtype).reshape(2, B, Sb, Kl, hd)
                        for p, g in enumerate(got) if p % span == m % span],
                       dim=3)
    return {"k": kv[0], "v": kv[1]}


def _unit_prefill(cfg: ModelConfig, unit: dict, x: torch.Tensor,
                  media: Optional[torch.Tensor], *, max_seq: int,
                  impl: Optional[str]) -> tuple[torch.Tensor, dict]:
    B = x.shape[0]
    cut = cache_cut(get_ctx())[0] > 1
    caches = {}
    for i, spec in enumerate(cfg.pattern):
        lp = unit[f"layer{i}"]
        h = _norm(cfg, lp["norm1"], x)
        if spec.mixer == MAMBA2:
            y, st = L.mamba_forward(cfg, lp["mixer"], h, impl=impl)
            caches[f"layer{i}"] = st
        elif spec.mixer == CROSS_ATTN:
            # the media's k, v projected once, for the output and the
            # decode cache (the reference projects them twice)
            med = L.apply_norm(cfg, lp["media_norm"], media)
            y, k, v = L.cross_attention(cfg, lp["mixer"], h, med, impl=impl)
            M = k.shape[1]
            caches[f"layer{i}"] = _relayout(cfg, k, v, M, M, "media tokens") \
                if cut else {"k": k, "v": v}
        else:
            y, k, v = L.self_attention(cfg, lp["mixer"], h, mixer=spec.mixer,
                                       impl=impl)
            window = cfg.attn_window if spec.mixer == ATTN_CHUNKED else 0
            S = k.shape[1]      # the whole prompt, under seq_parallel too
            Sc = min(max_seq, window) if window else max_seq
            # ring buffer slot = pos % window: only the current (possibly
            # partial) chunk's tail belongs in the cache; S % window == 0
            # means decode starts a fresh chunk
            take = S % window if window else min(S, Sc)
            if cut:
                caches[f"layer{i}"] = _relayout(
                    cfg, k, v, Sc, take,
                    "window slots" if window else "positions")
            else:
                cache = _layer_cache(cfg, spec, B, max_seq, x.device)
                if take:
                    cache["k"][:, :take] = k[:, -take:]
                    cache["v"][:, :take] = v[:, -take:]
                caches[f"layer{i}"] = cache
        x = _mlp(cfg, spec, lp, x + y)
    return x, caches


def prefill(cfg: ModelConfig, params: Params, batch: dict, max_seq: int,
            impl: Optional[str] = None) -> tuple[torch.Tensor, Cache]:
    """Run the prompt (``batch["tokens"]``, with ``batch["media"]`` for a
    cross-attention model); returns (last-position logits (B, 1, Vp),
    cache sized for ``max_seq`` positions, a cross-attention layer's
    holding the media's K / V; under a cut, this rank's block of
    positions of every KV head).  Under ``seq_parallel`` the last
    position is the last TP rank's: each rank's last is gathered and the
    head reads that one."""
    with seq_layout(_seq_len(cfg, batch)):
        ctx = get_ctx()
        x = embed_inputs(cfg, params, batch)
        media = _media(cfg, batch, x)
        caches = []
        for i, unit in enumerate(params["units"]):
            x, cache_u = _unit_prefill(
                cfg, _gathered(cfg, unit, ("units", i)), x, media,
                max_seq=max_seq, impl=impl)
            caches.append(cache_u)
        x = _norm(cfg, params["final_norm"], x)[:, -1:]
        if seq_cut(ctx):
            x = tp_gather(ctx, x)[..., -x.shape[-1]:]
    with seq_layout(1, cut=False):
        return lm_head(cfg, params, x), caches


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _unit_decode(cfg: ModelConfig, unit: dict, cache_u: dict,
                 x: torch.Tensor, t: int) -> tuple[torch.Tensor, dict]:
    new_cache = {}
    for i, spec in enumerate(cfg.pattern):
        lp = unit[f"layer{i}"]
        cu = cache_u[f"layer{i}"]
        h = L.apply_norm(cfg, lp["norm1"], x)
        if spec.mixer == MAMBA2:
            y, st = L.mamba_forward(cfg, lp["mixer"], h, state=cu,
                                    decode=True)
        elif spec.mixer == ATTN_CHUNKED:
            # ring-buffer within the current chunk: local slot index
            y, st = L.attn_decode(cfg, lp["mixer"], h, cu, t,
                                  mixer=spec.mixer, slot=t % cfg.attn_window)
        else:
            y, st = L.attn_decode(cfg, lp["mixer"], h, cu, t,
                                  mixer=spec.mixer)
        new_cache[f"layer{i}"] = st
        x = _mlp(cfg, spec, lp, x + y)
    return x, new_cache


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, t: int) -> tuple[torch.Tensor, Cache]:
    """One token for every sequence. tokens: (B, 1) int; t: position.
    Attention caches are written in place.  The one position is never
    cut on the sequence (``seq_parallel`` leaves a decode step as it
    is)."""
    with seq_layout(1, cut=False):
        x = embed_inputs(cfg, params, {"tokens": tokens})
        new_cache = []
        for i, (unit, cache_u) in enumerate(zip(params["units"], cache)):
            x, cu = _unit_decode(cfg, _gathered(cfg, unit, ("units", i)),
                                 cache_u, x, int(t))
            new_cache.append(cu)
        x = L.apply_norm(cfg, params["final_norm"], x)
        return lm_head(cfg, params, x), new_cache
