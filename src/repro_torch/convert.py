"""Carry the system's state between the JAX package and the port.

The system has no weights: its state is the protocol config, the
per-session seeds and counter offsets, and the fault masks.  These
functions take that state in plain Python / numpy form -- the JAX
``AggConfig`` as ``dataclasses.asdict`` output, numpy arrays for the
session metadata -- so one config and one session can run on both
sides, and convert ring words at the numpy boundary.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.byzantine import ByzantineSpec
from repro_torch.core.plan import AggConfig, SessionMeta, words
from repro_torch.kernels.backend import IMPLS


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
