"""Majority voting + Byzantine fault injection.

Counterpart of ``repro/core/byzantine.py``.  Honest members hold
bitwise-identical partial aggregates, so the element-wise median of an
odd number of copies equals the honest value whenever a strict majority
of the copies is honest.  All ring values are int32 words (uint32 bits);
the digest's logical shift and wrapping sum run on widened values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.kernels.secure_agg.secure_agg import (M32, median_network,
                                                       mul32, narrow, s32,
                                                       wide)


def majority_vote(copies: torch.Tensor) -> torch.Tensor:
    """copies: (r, ...) int32 words, r odd -> the element-wise median in
    unsigned order, the majority value wherever a strict majority of the
    copies agree."""
    r = copies.shape[0]
    if r % 2 != 1:
        raise ValueError("vote redundancy must be odd")
    if r == 1:
        return copies[0]
    return narrow(torch.sort(wide(copies), dim=0).values[r // 2])


def majority_vote_list(copies: Sequence[torch.Tensor]) -> torch.Tensor:
    """The same over r separate int32-word tensors (r odd), through the
    kernel layer's odd-even min/max network: no (r, ...) stack is built,
    and the result is bit-identical to ``vote_combine``'s median."""
    if len(copies) % 2 != 1:
        raise ValueError("vote redundancy must be odd")
    return narrow(median_network([wide(c) for c in copies]))


def digest_rows(x: torch.Tensor, n_words: int = 16) -> torch.Tensor:
    """Row-wise keyed mixing checksum: (B, T) int32 words -> (B, n_words)
    int32 words, each row as :func:`digest` of that row."""
    B, T = x.shape
    pad = (-T) % n_words
    flat = wide(x)
    if pad:
        flat = torch.cat([flat, flat.new_zeros((B, pad))], dim=1)
    blocks = flat.reshape(B, -1, n_words)
    idx = torch.arange(blocks.shape[1], dtype=torch.int64,
                       device=x.device)[:, None]
    mixed = mul32(blocks ^ mul32(idx, 0x9E3779B9), 0x85EBCA6B)
    mixed = mixed ^ (mixed >> 13)        # logical: ``mixed`` is wide
    return narrow(mixed.sum(dim=1))


def digest(x: torch.Tensor, n_words: int = 16) -> torch.Tensor:
    """Keyed mixing checksum of an int32-word tensor -> (n_words,)."""
    return digest_rows(x.reshape(1, -1), n_words)[0]


def add32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod 2^32 on int32 words."""
    return narrow(wide(a) + wide(b))


def digest_vote_combine(payload: torch.Tensor,
                        dg_copies: Sequence[torch.Tensor],
                        base: torch.Tensor,
                        backup: Optional[torch.Tensor] = None,
                        n_words: int = 16) -> torch.Tensor:
    """The digest transport's receive step: digest the (B, T) payload
    row-wise, accept it iff a strict majority of the r received digest
    copies equal its own digest, else take ``backup`` (when compiled
    in), and add to ``base``."""
    r = len(dg_copies)
    if r % 2 != 1:
        raise ValueError("vote redundancy must be odd")
    dgp = digest_rows(payload, n_words)
    votes = torch.zeros((payload.shape[0],), dtype=torch.int64,
                        device=payload.device)
    for d in dg_copies:
        votes = votes + (dgp == d).all(dim=-1)
    ok = votes > r // 2
    recv = payload if backup is None else torch.where(ok[:, None], payload,
                                                      backup)
    return add32(base, recv)


def corrupt_value(mode: str, x: torch.Tensor) -> torch.Tensor:
    """What a corrupt member sends instead of ``x``."""
    if mode == "flip":
        return x ^ -1
    if mode == "garbage":
        return narrow(mul32(wide(x), 2654435761) + 0xDEADBEEF)
    if mode == "drop":
        return torch.zeros_like(x)
    raise ValueError(f"unknown fault mode {mode!r}")


# ---------------------------------------------------------------------------
# Adversary semantics: fault-mode strings -> per-wire sent values.  A mode
# is ``base`` or ``base@k`` (from voted round k on); see the reference
# module for the digest adversaries "equivocate" and "mismatch".
# ---------------------------------------------------------------------------

_STREAM_SALT = 0x9E3779B9


def parse_mode(mode: str) -> tuple[str, int]:
    """``"garbage@2"`` -> ``("garbage", 2)``."""
    base, _, frm = mode.partition("@")
    return base, int(frm) if frm else 0


def _stream_salt(stream: int) -> int:
    """The int32 word of ``(_STREAM_SALT * (stream + 1)) mod 2^32``."""
    return s32((_STREAM_SALT * (stream + 1)) & M32)


def sent_value(base: str, view: str, x: torch.Tensor) -> torch.Tensor:
    """Value a corrupt node ships instead of honest ``x`` on one wire;
    ``view`` is "payload" or "digest"."""
    if base == "equivocate":
        return x
    if base == "mismatch":
        return corrupt_value("garbage", x) if view == "payload" else x
    return corrupt_value(base, x)


def equivocate_digest(dg: torch.Tensor, stream: int) -> torch.Tensor:
    """The digest this node ships on copy stream ``stream``."""
    return dg ^ _stream_salt(stream)


def equivocate_payload(x: torch.Tensor, stream: int) -> torch.Tensor:
    """Full-transport equivocation: a different corrupt payload per copy
    stream."""
    return corrupt_value("garbage", x) ^ _stream_salt(stream)


@dataclasses.dataclass(frozen=True)
class ByzantineSpec:
    """Static description of injected faults: ``corrupt_ranks`` are flat
    node ids whose outgoing hop messages are corrupted under ``mode``."""
    corrupt_ranks: tuple[int, ...] = ()
    mode: str = "flip"  # flip | garbage | drop | equivocate | mismatch | m@k
