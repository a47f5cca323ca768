"""Carry the system's state between the JAX package and the port.

The aggregation system has no weights: its state is the protocol config,
the per-session seeds and counter offsets, the fault masks, and for the
paper's DA protocol the threshold key material and the overlay.  The
model stack adds a model config and its weights.  These functions take
that state in plain Python / numpy form -- the JAX ``AggConfig``,
``ModelConfig``, ``ThresholdPublic`` and shares as ``dataclasses.asdict``
output, numpy arrays for the session metadata and the weights, plain
fields for the overlay -- so one config, one session, one key, one
overlay and one set of weights can run on both sides, and convert ring
words at the numpy boundary.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import (LayerSpec, ModelConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.core.byzantine import ByzantineSpec
from repro_torch.core.overlay import MsgStats, Node, Overlay
from repro_torch.core.plan import AggConfig, SessionMeta, words
from repro_torch.crypto.paillier import (PublicKey, ThresholdPublic,
                                         ThresholdShare)
from repro_torch.kernels.backend import IMPLS
from repro_torch.runtime.chaos import ChaosConfig
from repro_torch.runtime.fault import SessionFaultPlan
from repro_torch.runtime.resilience import RetryPolicy
from repro_torch.service.epochs import EpochSnapshot
from repro_torch.service.executor import BatchingConfig, StreamConfig
from repro_torch.service.session import SessionParams


def config_from_fields(d: dict) -> AggConfig:
    """A config from ``dataclasses.asdict`` of the reference's
    ``AggConfig`` (the nested ``ByzantineSpec`` as a dict).  The
    reference's kernel engines (``pallas`` / ``pallas_interpret`` /
    ``jnp``) have no counterpart here; the port picks its kernels by
    device, so they map to ``None``."""
    fields = {f.name for f in dataclasses.fields(AggConfig)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown AggConfig fields {sorted(unknown)}")
    kw = dict(d)
    byz = kw.get("byzantine")
    if isinstance(byz, dict):
        kw["byzantine"] = ByzantineSpec(
            corrupt_ranks=tuple(int(r) for r in byz.get("corrupt_ranks", ())),
            mode=byz.get("mode", "flip"))
    if kw.get("kernel_impl") not in IMPLS:
        kw["kernel_impl"] = None
    return AggConfig(**kw)


def session_meta_from_numpy(seeds, offsets, fault_masks, device
                            ) -> SessionMeta:
    """(S,) uint32 seeds and offsets and {mode: (S, n) bool} masks, as
    numpy, -> a :class:`SessionMeta` on ``device``."""
    return SessionMeta(
        seeds=words(seeds, device), offsets=words(offsets, device),
        fault_masks={k: torch.as_tensor(np.asarray(m, bool), device=device)
                     for k, m in dict(fault_masks or {}).items()})


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32-word tensor -> numpy uint32 with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32)


def words_from_numpy(a, device="cpu") -> torch.Tensor:
    """numpy uint32 -> int32-word tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def threshold_from_fields(pub: dict, shares: list[dict]
                          ) -> tuple[ThresholdPublic, list[ThresholdShare]]:
    """The port's threshold key from ``dataclasses.asdict`` of the
    reference's ``ThresholdPublic`` (``pk`` nested as ``{"n": ...}``) and
    of each of its ``ThresholdShare``s."""
    tp = ThresholdPublic(pk=PublicKey(int(pub["pk"]["n"])), t=int(pub["t"]),
                         c=int(pub["c"]), delta=int(pub["delta"]))
    return tp, [ThresholdShare(int(s["index"]), int(s["value"]))
                for s in shares]


_OVERLAY_PARAMS = ("n_target", "tau", "k", "msg_size", "g")


def overlay_fields(ov) -> dict:
    """Plain fields of an overlay of either package: its parameters, its
    nodes (uid, pos, honest), its message stats and the state of its
    random draws, so further churn replays identically."""
    return {**{k: getattr(ov, k) for k in _OVERLAY_PARAMS},
            "nodes": [dataclasses.asdict(nd) for nd in ov.nodes.values()],
            "next_uid": ov._next_uid,
            "stats": {"messages": ov.stats.messages,
                      "bytes": ov.stats.bytes},
            "rng_state": ov.rng.getstate()}


def overlay_from_fields(d: dict) -> Overlay:
    """An :class:`Overlay` with the same nodes, cluster count g, stats and
    random state as the overlay :func:`overlay_fields` read."""
    ov = Overlay(n_target=d["n_target"], tau=d["tau"], k=d["k"],
                 msg_size=d["msg_size"])
    ov.g = int(d["g"])
    for nd in d["nodes"]:
        ov.nodes[int(nd["uid"])] = Node(int(nd["uid"]), float(nd["pos"]),
                                        bool(nd["honest"]))
    ov._next_uid = int(d["next_uid"])
    ov.stats = MsgStats(int(d["stats"]["messages"]), int(d["stats"]["bytes"]))
    ov.rng.setstate(d["rng_state"])
    return ov


def model_config_from_fields(d: dict) -> ModelConfig:
    """A model config from ``dataclasses.asdict`` of the reference's
    ``ModelConfig`` (``pattern`` as a sequence of dicts, ``moe`` and
    ``ssm`` as dicts or None), so a test's ``dataclasses.replace`` of a
    reference config carries across."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown ModelConfig fields {sorted(unknown)}")
    kw = dict(d)
    kw["pattern"] = tuple(LayerSpec(**dict(s)) for s in kw["pattern"])
    if kw.get("moe") is not None:
        kw["moe"] = MoEConfig(**dict(kw["moe"]))
    if kw.get("ssm") is not None:
        kw["ssm"] = SSMConfig(**dict(kw["ssm"]))
    return ModelConfig(**kw)


def model_params_from_numpy(cfg: ModelConfig, params_np: dict,
                            device="cpu") -> dict:
    """The port's params from the reference's, as a nested dict of numpy
    arrays.  The reference's ``params["units"]`` leaves carry a leading
    ``n_units`` axis (its ``init_params`` vmaps the unit init); here they
    are split into a list of per-unit dicts."""

    def tensors(tree, index=None):
        if isinstance(tree, dict):
            return {k: tensors(v, index) for k, v in tree.items()}
        a = np.asarray(tree)
        if index is not None:
            a = a[index]
        return torch.from_numpy(np.array(a, dtype=a.dtype)).to(device)

    out = {k: tensors(v) for k, v in params_np.items() if k != "units"}
    out["units"] = [tensors(params_np["units"], u)
                    for u in range(cfg.n_units)]
    return out


def _from_fields(cls, d: dict, tuples: tuple = ()):
    """``cls`` from ``dataclasses.asdict`` of the reference's class of the
    same name and fields; ``tuples`` name the fields asdict may hand
    back as lists."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields {sorted(unknown)}")
    kw = dict(d)
    for name in tuples:
        if kw.get(name) is not None:
            kw[name] = tuple(kw[name])
    return cls(**kw)


def session_params_from_fields(d: dict) -> SessionParams:
    """The reference's ``SessionParams`` fields -> the port's."""
    return _from_fields(SessionParams, d)


def batching_from_fields(d: dict) -> BatchingConfig:
    """The reference's ``BatchingConfig`` fields -> the port's (a
    ``tuned`` pad map is copied, not shared)."""
    kw = dict(d)
    if kw.get("tuned") is not None:
        kw["tuned"] = dict(kw["tuned"])
    return _from_fields(BatchingConfig, kw, tuples=("pad_buckets",))


def stream_from_fields(d: dict) -> StreamConfig:
    """The reference's ``StreamConfig`` fields -> the port's."""
    return _from_fields(StreamConfig, d)


def retry_from_fields(d: dict) -> RetryPolicy:
    """The reference's ``RetryPolicy`` fields -> the port's (its
    ``sleep`` callable carried as it is)."""
    return _from_fields(RetryPolicy, d)


def chaos_from_fields(d: dict) -> ChaosConfig:
    """The reference's ``ChaosConfig`` fields -> the port's."""
    return _from_fields(ChaosConfig, d, tuples=("poison_sids",))


def fault_plan_from_fields(d: dict) -> SessionFaultPlan:
    """The reference's ``SessionFaultPlan`` fields -> the port's."""
    return _from_fields(SessionFaultPlan, d,
                        tuples=("crashed_slots", "byzantine_slots"))


def epoch_snapshot_from_fields(d: dict) -> EpochSnapshot:
    """The reference's ``EpochSnapshot`` fields -> the port's."""
    return _from_fields(EpochSnapshot, d, tuples=("slot_uids", "honest"))
