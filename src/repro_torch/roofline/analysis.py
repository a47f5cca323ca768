"""Op-counted roofline analysis of a traced step: the counterpart of the
reference's HLO parser (``repro/roofline/analysis.py``).

The port runs eagerly, so there is no compiled program to parse: the
step runs once on meta tensors (shapes and dtypes, no data, no device)
under :class:`OpCounter`, a ``TorchDispatchMode`` that sees every aten op
of this rank's step, its backward included:

  * FLOPs: the matmul-class ops (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, convolutions, SDPA) counted as ``torch.utils.
    flop_counter`` counts them, plus each kernel's work as its wrapper's
    meta route records it (``kernels.backend.record_meta``, from
    ``roofline.counts``; ``count`` opens ``backend.meta_route``);
  * HBM bytes: each op's tensor operands plus its outputs (views,
    allocations and the collectives themselves move none; an indexed
    write moves its source twice and its indices, an indexed read its
    output twice and its indices, as the reference's parser counts
    scatters and gathers), plus each kernel's bytes.  The port runs op by
    op, so this is its own traffic, not an estimate of what a fusing
    compiler would leave;
  * collective bytes: the tally of ``runtime.context`` (every TP, EP and
    FSDP collective and the step's gradient sums), by kind: ``tp_sum``,
    ``tp_cat``, ``tp_seq_gather`` / ``tp_seq_scatter`` (the sequence's
    all-gathers and reduce-scatters under ``seq_parallel``),
    ``tp_loss`` (the vocabulary-parallel loss's three float32 (B, S)
    all-reduces), ``ep_exchange`` / ``ep_sum``, ``dp_pool`` (the GSPMD
    step's expert dispatch pooling a data block's expert ids over the
    pods),
    ``fsdp_gather`` / ``fsdp_scatter`` and ``dp_sum``;
  * peak live bytes: a tensor's storage counted when an op makes it and
    released when it is freed, the highest total over the step (the
    counterpart of XLA's ``temp_size``: the step's arguments are not in
    it).

``roofline_terms`` and ``model_flops_per_step`` keep the reference's
formulas, ``roofline_terms`` on the H100's datasheet constants
(``roofline.hw``): its terms are estimates, never measurements.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import backend
from repro_torch.roofline import hw
from repro_torch.runtime import context

# ops that allocate without touching memory
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh", "_local_scalar_dense"}
# indexed writes into their first argument: the rows written, not the
# whole buffer (read-modify-write of the source's size, and the indices)
_SCATTERS = {"index_copy", "index_copy_", "index_put", "index_put_",
             "scatter", "scatter_", "scatter_add", "scatter_add_",
             "index_add", "index_add_", "_index_put_impl_"}
# indexed reads: the rows read (the output's size twice) and the indices
_GATHERS = {"index", "index_select", "gather", "embedding"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes and live storage of every aten op run
    under it (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._storages: dict = {}

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            self.live -= n
            self._storages.pop(key, None)

        self._storages[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out                    # the collectives: tallied apart
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if getattr(func, "is_view", False) or \
                packet.__name__ in _NO_TRAFFIC:
            return out
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        name = packet.__name__
        if name in _SCATTERS and ins:
            self.hbm_bytes += sum(_nbytes(t) * (1 if t.dtype in (
                torch.int64, torch.int32) else 2) for t in ins[1:])
        elif name in _GATHERS and ins:
            self.hbm_bytes += 2 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins[1:])
        else:
            self.hbm_bytes += sum(_nbytes(t) for t in ins)
            self.hbm_bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


def count(fn, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` (on meta tensors) under an
    :class:`OpCounter`; returns (its result, the counted dict: ``flops``,
    ``hbm_bytes``, ``collective_bytes`` by kind, ``collective_calls``,
    ``collective_bytes_total``, ``kernels`` (the meta route's record a
    kernel), ``peak_live_bytes``, ``aten_ops``)."""
    context.reset_collective_counts()
    backend.reset_meta_counts()
    counter = OpCounter()
    with backend.meta_route(), counter:
        out = fn(*args, **kwargs)
    kernels = backend.meta_counts()
    coll = context.collective_counts()
    counted = {
        "flops": counter.flops + sum(k["flops"] for k in kernels.values()),
        "flops_aten": counter.flops,
        "int_ops_kernels": sum(k["int_ops"] for k in kernels.values()),
        "hbm_bytes": counter.hbm_bytes + sum(k["bytes"]
                                             for k in kernels.values()),
        "collective_bytes": {k: v["bytes"] for k, v in coll.items()},
        "collective_calls": {k: v["calls"] for k, v in coll.items()},
        "collective_bytes_total": sum(v["bytes"] for v in coll.values()),
        "kernels": kernels,
        "peak_live_bytes": counter.peak,
        "aten_ops": counter.ops,
    }
    return out, counted


def roofline_terms(counted: dict, *, n_links: int = 1) -> dict:
    """Per-device seconds of the three roofline terms, the reference's
    formulas on the H100's datasheet constants (``NVLINK_BW`` is already
    the card's whole NVLink rate, so one "link")."""
    compute = counted["flops"] / hw.PEAK_FLOPS_BF16
    memory = counted["hbm_bytes"] / hw.HBM_BW
    collective = counted["collective_bytes_total"] / (n_links * hw.NVLINK_BW)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    bound = max(compute, memory, collective)
    terms["roofline_fraction"] = compute / bound if bound > 0 else 0.0
    return terms


def model_flops_per_step(cfg, shape) -> float:
    """6*N_active*D (+ attention term) — the 'useful' FLOPs yardstick
    (the reference's formula, kept as it is)."""
    tokens = shape.global_batch * shape.seq_len
    n_active = cfg.active_param_count()
    base = 6.0 * n_active * tokens
    # attention score/context flops: 12 * B * S^2 * H * hd per layer (fwd+bwd)
    attn = 0.0
    for spec in cfg.layer_specs():
        if spec.mixer in ("attn", "cross_attn"):
            s_eff = shape.seq_len
        elif spec.mixer == "attn_chunked":
            s_eff = min(cfg.attn_window or shape.seq_len, shape.seq_len)
        else:
            continue
        attn += 12.0 * shape.global_batch * shape.seq_len * s_eff \
            * cfg.n_heads * cfg.hd * (0.5 if cfg.causal else 1.0)
    if shape.kind != "train":
        base /= 3.0   # no backward
        attn /= 3.0
    if shape.kind == "decode":
        base = 2.0 * n_active * shape.global_batch  # one token per seq
        attn = 0.0  # decode attention is matvec over cache: memory bound
    return base + attn
