"""Parameter / batch / cache sharding rules, and the cut of a rank's
slice.

Counterpart of ``repro/launch/sharding.py``.  A spec is a tuple with one
entry a dimension: ``None`` (whole), an axis name, or a tuple of axis
names; the reference's rules give them leaf by leaf (``param_specs``,
``opt_specs``, ``batch_specs``), with its substring tests on the leaf's
path: tensor parallelism (TP) over ``"model"`` on the heads of ``wq`` /
``wk`` / ``wv`` and their biases and the rows of ``wo``, on ``d_ff`` and
an expert's ``f_e``, on the vocabulary of ``embed`` and ``head``, and on
the Mamba2 ``d_inner`` channels of ``in_z`` / ``in_x`` / ``conv_x`` /
``conv_xb`` / ``out_norm`` and the rows of ``out_proj``; the expert
stacks split over ``"data"`` (expert parallelism); for a config with
``dp_mode="fsdp"`` the other matrix dimension on ``"data"``.  The port's
``params["units"]`` is a list of unit dicts, so a unit leaf has no
stacked units dimension and its spec none either (the reference's first
entry there is always ``None``).

The reference hands the specs to GSPMD.  The port has no GSPMD: a rank
holds only its slice (``shard_tree``), cut on ``"model"``, for the
expert stacks on ``"data"``, and with ``fsdp="data"`` (fully sharded
data parallelism, FSDP) on the ``"data"`` entries of a ``dp_mode="fsdp"``
config too.  Every such entry lies on a matrix's ``d_model`` side (the
rows of ``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up`` / ``head`` /
``router`` / ``in_*``, the columns of ``wo`` / ``w_down`` /
``out_proj``), so a leaf is an FSDP slice exactly where that dimension is
shorter than ``d_model`` (``fsdp_dim``): the layers gather it over
``"data"`` where they use it (``runtime.context.fsdp_gather``) and take
a whole leaf as it is.  A tied ``embed`` stays whole on ``"data"``, as
the reference's rule gives, and ``"pod"`` replicates.  One thing
differs from a plain cut of the specs: ``wk`` / ``wv`` / ``bk`` / ``bv``
are cut by KV heads: a rank holds the ``H / tp`` query heads of its
block and the KV heads that those heads read, so where ``K < tp`` a KV
head is held by the ``tp / K`` ranks that read it (GSPMD would split its
``hd`` there); an FSDP cut of ``wk`` / ``wv`` lies on their rows beside
it.  And where the ``H`` query heads do not split over ``tp`` (GSPMD
cuts mid-head and lets XLA pad), each KV group of ``H / K`` heads is
padded with zero heads to ``models.layers.q_group`` (llama4-maverick at
TP 16: groups of 5 to 6, 48 heads, 3 a rank): a rank's ``wq`` / ``bq``
columns and ``wo`` rows hold its heads of the padded order
(``q_heads``), a pad head's all zero.  Its q is zero, so its output is
the mean of V, which its zero ``wo`` rows drop; its gradient is dropped
too (``zero_pad_heads_``), so no update moves it; ``unshard_tree``
returns the unpadded leaves.

A KV head count that neither divides nor is divided by the TP extent,
``d_ff``, an expert's ``f_e``, the shared expert, the padded vocabulary
or the SSD heads that do not split raise ``ConfigError``
(``check_tp``): nothing runs unsharded in its place.

``cache_specs`` is the reference's: a K / V leaf holds every KV head,
its positions cut over ``"model"`` where the batch splits over the dp
ranks and over ``("data", "model")`` where it does not (``cache_axes``);
the Mamba2 states lie on their heads and channels.  A rank's cache is
its block (``models.model.init_cache`` under the serving context).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.engine import tree_flatten
from repro_torch.core.schedules import ConfigError
from repro_torch.models import model as M
from repro_torch.models.layers import kv_block, q_group, q_heads

DP = ("pod", "data")    # logical dp axes; missing mesh axes are dropped
TP_AXIS = "model"
FSDP_AXIS = "data"      # the axis FSDP cuts the weights over
KV_LEAVES = ("wk", "wv", "bk", "bv")
# an attention layer's leaves cut by query head, and the dimension
Q_LEAVES = {"wq": -1, "bq": -1, "wo": 0}


class AbstractMesh:
    """Axis names and extents with no process group: what the spec rules
    read (the reference's ``jax.sharding.AbstractMesh``), and the
    coordinates of any rank, row-major as ``compat.NodeMesh``'s."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())

    def coord(self, axis: str, rank: int) -> int:
        r = rank
        for name in reversed(self.axis_names):
            r, c = divmod(r, self.shape[name])
            if name == axis:
                return c
        raise KeyError(axis)


def _trim(spec: Sequence, mesh) -> tuple:
    """Drop axis names the mesh doesn't have (single-pod vs multi-pod); a
    tuple of one name left is that name, as ``PartitionSpec`` writes
    it."""
    names = set(mesh.axis_names)

    def keep(e):
        if e is None:
            return None
        if isinstance(e, tuple):
            t = tuple(a for a in e if a in names)
            return (t[0] if len(t) == 1 else t) if t else None
        return e if e in names else None

    return tuple(keep(e) for e in spec)


def _leaf_spec(path: str, shape: tuple, fsdp: Optional[str]) -> tuple:
    """The reference's ``_leaf_spec``, rule for rule."""
    f = fsdp
    if "embed" in path:
        return ("model", None)
    if "head" in path:
        return (f, "model")
    if "router" in path:
        return (f, None)
    if "mlp" in path and len(shape) == 3:          # expert stacks: EP
        if "w_down" in path:
            return ("data", "model", None)
        return ("data", None, "model")
    if "shared" in path or "mlp" in path:
        if "w_down" in path:
            return ("model", f)
        if len(shape) == 2:
            return (f, "model")
        return ("model",) if len(shape) == 1 else (None,)
    if "mixer" in path:
        if any(k in path for k in ("wq", "wk", "wv")):
            return (f, "model")
        if "wo" in path:
            return ("model", f)
        if any(k in path for k in ("bq", "bk", "bv")):
            return ("model",)
        if any(k in path for k in ("in_z", "in_x")):
            return (f, "model")
        if any(k in path for k in ("in_B", "in_C", "in_dt")):
            return (f, None)
        if "out_proj" in path:
            return ("model", f)
        if "conv_x" in path and len(shape) == 2:
            return (None, "model")
        if "conv_xb" in path or "out_norm" in path:
            return ("model",)
    return (None,) * len(shape)


def _keystr(path: tuple) -> str:
    """A key path as ``jax.tree_util.keystr`` prints it."""
    return "".join(f"[{k!r}]" for k in path)


def _leaves_with_paths(tree, path: tuple = (), specs: bool = False
                       ) -> list:
    """(key path, leaf) in ``tree_flatten``'s order; with ``specs`` a
    tuple is a leaf (a spec)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_paths(tree[k], path + (k,), specs)]
    if isinstance(tree, list) or (isinstance(tree, tuple) and not specs):
        return [x for i, v in enumerate(tree)
                for x in _leaves_with_paths(v, path + (i,), specs)]
    return [(path, tree)]


def _map_with_path(fn, tree):
    _, rebuild = tree_flatten(tree)
    return rebuild([fn(path, leaf)
                    for path, leaf in _leaves_with_paths(tree)])


def _spec_of(cfg: ModelConfig, path: tuple, ndim: int, shape: tuple,
             mesh, fsdp: Optional[str]) -> tuple:
    spec = _leaf_spec(_keystr(path), shape, fsdp)
    if len(spec) != ndim:
        spec = tuple(spec) + (None,) * (ndim - len(spec))
    return _trim(spec, mesh)


def param_specs(cfg: ModelConfig, params: Any, mesh,
                fsdp: Optional[str] = "data") -> Any:
    """A tree of ``params``'s structure holding each leaf's spec."""
    if cfg.dp_mode == "replicated":
        fsdp = None
    return _map_with_path(
        lambda path, leaf: _spec_of(cfg, path, leaf.dim(),
                                    tuple(leaf.shape), mesh, fsdp), params)


def opt_specs(cfg: ModelConfig, opt_state: Any, pspecs: Any, mesh) -> Any:
    """AdamW's moments mirror the parameters; the step is replicated."""
    return {"m": pspecs, "v": pspecs, "step": ()}


def dp_extent(mesh) -> int:
    return math.prod(mesh.shape[a] for a in DP if a in mesh.axis_names)


def batch_splits(global_batch: int, mesh) -> bool:
    """Does the batch split over the mesh's dp ranks (the reference's
    test: it divides and is at least their count)?"""
    n = dp_extent(mesh)
    return global_batch % n == 0 and global_batch >= n


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """The batch over the dp axes where it splits, else replicated."""
    b = _trim((DP,), mesh) if batch_splits(shape.global_batch, mesh) \
        else (None,)
    out = {}
    if cfg.frontend == "audio_frames":
        out["frames"] = b + (None, None)
    else:
        out["tokens"] = b + (None,)
    if shape.kind == "train":
        out["labels"] = b + (None,)
    if cfg.frontend == "vision_patches":
        out["media"] = b + (None, None)
    return out


def cache_axes(global_batch: int, mesh) -> tuple:
    """The axes the KV cache's positions are cut over, major to minor:
    ``"model"`` where the batch splits over the dp ranks, else
    ``("data", "model")`` (the long-context cells at batch 1); ``"pod"``
    replicates."""
    return ("model",) if batch_splits(global_batch, mesh) \
        else ("data", "model")


def cache_specs(cfg: ModelConfig, cache: Any, shape: ShapeConfig,
                mesh) -> Any:
    """The reference's rule, leaf for leaf: the batch over dp where it
    splits; a K / V leaf's sequence over ``cache_axes`` (``"model"``, or
    ``("data", "model")`` where the batch does not split), its heads
    whole; the Mamba2 SSD heads and ``conv_x``'s ``d_inner`` channels on
    ``"model"``; the small ``conv_B`` / ``conv_C`` states replicated."""
    b = (DP,) if batch_splits(shape.global_batch, mesh) else (None,)
    seq = cache_axes(shape.global_batch, mesh)
    seq = seq[0] if len(seq) == 1 else seq

    def one(path, leaf):
        name = path[-1]
        if name in ("k", "v"):
            spec = b + (seq, None, None)
        elif name == "ssd":
            spec = b + ("model", None, None)
        elif name == "conv_x":
            spec = b + (None, "model")
        else:
            spec = (None,) * leaf.dim()
        return _trim(spec, mesh)

    return _map_with_path(one, cache)


# ---------------------------------------------------------------------------
# This rank's slice
# ---------------------------------------------------------------------------


def tp_extent(mesh) -> int:
    if mesh is None or TP_AXIS not in mesh.axis_names:
        return 1
    return mesh.shape[TP_AXIS]


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """Raise ``ConfigError`` where ``tp`` ranks cannot split ``cfg``'s
    TP dimensions (the KV heads, which must divide or be divided by
    ``tp``; then the query heads split, padded where they do not divide;
    d_ff, f_e, the shared expert, the padded vocabulary, the SSD
    heads)."""
    if tp == 1:
        return
    H, K = cfg.n_heads, cfg.n_kv_heads
    specs = cfg.layer_specs()
    attn = any(s.mixer != "mamba2" for s in specs)
    bad = []
    if attn and K % tp and tp % K:
        if H % tp:
            bad.append(f"{H} query heads")
        bad.append(f"{K} KV heads (neither divides the other)")
    if any(s.mlp == "dense" for s in specs) and cfg.d_ff % tp:
        bad.append(f"d_ff {cfg.d_ff}")
    if cfg.moe is not None:
        if cfg.moe.d_expert % tp:
            bad.append(f"f_e {cfg.moe.d_expert}")
        if cfg.moe.d_shared % tp:
            bad.append(f"the shared expert's {cfg.moe.d_shared}")
    if M.padded_vocab(cfg) % tp:
        bad.append(f"the padded vocabulary {M.padded_vocab(cfg)}")
    if cfg.ssm is not None and any(s.mixer == "mamba2" for s in specs):
        nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        if nh % tp:
            bad.append(f"{nh} SSD heads")
    if bad:
        raise ConfigError(f"{cfg.name}: {', '.join(bad)} do not split over "
                          f"the {tp} ranks of {TP_AXIS!r}")


def pad_heads(cfg: ModelConfig, tp: int) -> int:
    """The zero heads the padded split adds over ``tp`` TP ranks (0
    where the query heads split)."""
    return cfg.n_kv_heads * q_group(cfg, tp) - cfg.n_heads


def zero_pad_heads_(cfg: ModelConfig, tree: Any, mesh) -> None:
    """Zero, in place, the pad heads' entries of this rank's tree (its
    gradients: the ``wq`` / ``bq`` columns and ``wo`` rows of its zero
    heads)."""
    tp = tp_extent(mesh)
    if tp == 1 or not pad_heads(cfg, tp):
        return
    heads = q_heads(cfg, tp, mesh.coord(TP_AXIS))
    hd = cfg.hd
    for path, leaf in _leaves_with_paths(tree):
        d = Q_LEAVES.get(path[-1])
        if d is None or "mixer" not in path:
            continue
        for i, h in enumerate(heads):
            if h is None:
                leaf.narrow(d, i * hd, hd).zero_()


def entry_axes(e, mesh) -> tuple:
    """The axes of more than one rank that one spec entry names."""
    axes = () if e is None else (e if isinstance(e, tuple) else (e,))
    return tuple(a for a in axes if mesh.shape[a] > 1)


def fsdp_extent(cfg: ModelConfig, mesh) -> int:
    """The FSDP axis's extent for ``cfg`` on ``mesh`` (1: no FSDP)."""
    if mesh is None or cfg.dp_mode != "fsdp" or FSDP_AXIS not in \
            mesh.axis_names:
        return 1
    return mesh.shape[FSDP_AXIS]


def _fsdp_spec_dim(path: tuple, shape: tuple) -> Optional[int]:
    """The dimension the reference's rules put ``"data"`` on for FSDP
    (not an expert stack's expert dimension), or None."""
    key = _keystr(path)
    plain = _leaf_spec(key, shape, None)
    fsdp = _leaf_spec(key, shape, FSDP_AXIS)
    for d, (a, b) in enumerate(zip(plain, fsdp)):
        if b == FSDP_AXIS and a != FSDP_AXIS:
            return d
    return None


def fsdp_dim(cfg: ModelConfig, path: tuple, leaf) -> Optional[int]:
    """The dimension on which ``leaf`` (at key ``path``, a rank's leaf) is
    an FSDP slice, or None where it is whole there: every FSDP entry lies
    on a ``d_model`` dimension, so a slice is one shorter than
    ``d_model``."""
    if cfg.dp_mode != "fsdp":
        return None
    d = _fsdp_spec_dim(path, tuple(leaf.shape))
    if d is None or d >= leaf.dim() or leaf.shape[d] >= cfg.d_model:
        return None
    return d


def cut_axes(cfg: ModelConfig, path: tuple, leaf, mesh) -> tuple:
    """The mesh axes of more than one rank that a rank's ``leaf`` is a
    slice on, in the mesh's order: its TP and expert cuts, and
    ``"data"`` where it is an FSDP slice."""
    spec = _spec_of(cfg, path, leaf.dim(), tuple(leaf.shape), mesh, None)
    cut = {a for e in spec for a in entry_axes(e, mesh)}
    if fsdp_dim(cfg, path, leaf) is not None:
        cut.add(FSDP_AXIS)
    return tuple(a for a in mesh.axis_names if a in cut)


def _cuts(cfg: ModelConfig, path: tuple, spec: tuple, mesh, rank
          ) -> list:
    """Per dimension: None (whole) or (block index, block count); a KV
    leaf's head dimension ("kv", first head, heads); a query-head leaf's
    ("q", TP extent, TP index).  With FSDP off the only "data" entries
    are the expert stacks'."""
    out = []
    for e in spec:
        axes = entry_axes(e, mesh)
        if not axes:
            out.append(None)
            continue
        if axes == (TP_AXIS,) and path[-1] in KV_LEAVES + tuple(Q_LEAVES):
            tp, idx = mesh.shape[TP_AXIS], mesh.coord(TP_AXIS, rank)
            if path[-1] in KV_LEAVES:
                lo, n = kv_block(cfg, tp, idx)
                out.append(("kv", lo, n))
            else:
                out.append(("q", tp, idx))
            continue
        idx, count = 0, 1
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coord(a, rank)
            count *= mesh.shape[a]
        out.append((idx, count))
    return out


def _slices(cfg: ModelConfig, cuts: list, full_shape: tuple) -> tuple:
    """The slice of each dimension (all of a query-head dimension)."""
    sl = []
    for c, n in zip(cuts, full_shape):
        if c is None or c[0] == "q":
            sl.append(slice(None))
        elif c[0] == "kv":
            sl.append(slice(c[1] * cfg.hd, (c[1] + c[2]) * cfg.hd))
        else:
            w = n // c[1]
            sl.append(slice(c[0] * w, (c[0] + 1) * w))
    return tuple(sl)


def _head_pieces(cfg: ModelConfig, cuts: list) -> Optional[tuple]:
    """(dimension, the rank's heads) of a query-head cut, or None."""
    for d, c in enumerate(cuts):
        if c is not None and c[0] == "q":
            return d, q_heads(cfg, c[1], c[2])
    return None


def _piece(cfg: ModelConfig, leaf: torch.Tensor, cuts: list
           ) -> torch.Tensor:
    """A rank's piece of a full leaf: its blocks, and of a query-head
    dimension its heads in order (zeros for a pad head)."""
    out = leaf[_slices(cfg, cuts, tuple(leaf.shape))]
    q = _head_pieces(cfg, cuts)
    if q is None:
        return out
    d, heads = q
    hd = cfg.hd
    if None not in heads:       # an even split: a block of heads
        return out.narrow(d, heads[0] * hd, len(heads) * hd)
    zero = out.new_zeros(out.shape[:d] + (hd,) + out.shape[d + 1:])
    return torch.cat([zero if h is None else out.narrow(d, h * hd, hd)
                      for h in heads], dim=d)


def shard_tree(cfg: ModelConfig, tree: Any, mesh,
               rank: Optional[int] = None,
               fsdp: Optional[str] = None) -> Any:
    """This rank's (or ``rank``'s) slice of a full parameter tree (or of
    a tree of the parameters' structure), as contiguous copies; a leaf
    that is whole on the rank is the leaf itself.  ``fsdp="data"`` also
    cuts a ``dp_mode="fsdp"`` config's FSDP entries (the reference's
    ``param_specs`` default); with None they stay whole on every data
    rank, a layout the model layers take as well.  Raises
    ``ConfigError`` where the TP extent does not split ``cfg``."""
    check_tp(cfg, tp_extent(mesh))
    specs = param_specs(cfg, tree, mesh, fsdp=fsdp)
    out = []
    _, rebuild = tree_flatten(tree)
    for (path, leaf), spec in zip(_leaves_with_paths(tree),
                                  _spec_leaves(specs)):
        cuts = _cuts(cfg, path, spec, mesh, rank)
        if all(c is None for c in cuts):
            out.append(leaf)
        else:
            out.append(_piece(cfg, leaf, cuts).contiguous().clone())
    return rebuild(out)


def _spec_leaves(specs: Any) -> list:
    """The specs of a spec tree in ``tree_flatten``'s order."""
    return [s for _, s in _leaves_with_paths(specs, specs=True)]


def unshard_tree(cfg: ModelConfig, slices: Sequence, mesh) -> Any:
    """The full tree from every rank's slice (``slices[r]`` is rank r's
    ``shard_tree``, with or without its FSDP cut: an FSDP slice is read
    off its shape), the inverse of ``shard_tree``: for tests and for
    joining checkpoints."""
    per_rank = [_leaves_with_paths(t) for t in slices]
    _, rebuild = tree_flatten(slices[0])
    out = []
    for j, (path, leaf0) in enumerate(per_rank[0]):
        cut = fsdp_dim(cfg, path, leaf0) is not None
        spec = _spec_of(cfg, path, leaf0.dim(), tuple(leaf0.shape), mesh,
                        FSDP_AXIS if cut else None)
        cuts0 = _cuts(cfg, path, spec, mesh, 0)
        if all(c is None for c in cuts0):
            out.append(leaf0)
            continue
        shape = []
        for c, n in zip(cuts0, leaf0.shape):
            if c is None:
                shape.append(n)
            elif c[0] == "kv":
                shape.append(cfg.n_kv_heads * cfg.hd)
            elif c[0] == "q":
                shape.append(cfg.n_heads * cfg.hd)
            else:
                shape.append(n * c[1])
        full = torch.empty(shape, dtype=leaf0.dtype, device=leaf0.device)
        for r in range(mesh.size):
            cuts = _cuts(cfg, path, spec, mesh, r)
            block = full[_slices(cfg, cuts, tuple(shape))]
            piece = per_rank[r][j][1]
            q = _head_pieces(cfg, cuts)
            if q is None:
                block.copy_(piece)
                continue
            d, heads = q
            hd = cfg.hd
            for i, h in enumerate(heads):
                if h is not None:
                    block.narrow(d, h * hd, hd).copy_(
                        piece.narrow(d, i * hd, hd))
        out.append(full)
    return rebuild(out)
