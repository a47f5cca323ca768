"""Deterministic synthetic data pipeline.

Produces reproducible token/label batches (and stub modality inputs) per
(step, dp_rank) so that every DP rank reads a disjoint shard — the same
contract a production loader (tfds/grain) provides, without external
data.  A Zipf-ish unigram + Markov-bigram stream gives a learnable signal
(loss decreases) for the end-to-end examples.

A copy of the reference's ``repro/data/pipeline.py`` (numpy only), so the
port's prompts are the reference's prompts token for token.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 1234
    markov_order: bool = True   # bigram structure (learnable)


class SyntheticStream:
    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig):
        self.cfg = cfg
        self.mc = model_cfg
        v = model_cfg.vocab_size
        rng = np.random.default_rng(cfg.seed)
        # fixed random bigram table: next ~ P(. | prev), peaked
        self.base = rng.zipf(1.5, size=(4096,)) % v
        self.shift = rng.integers(1, v, size=(257,))

    def _tokens(self, step: int, rank: int, n: int, length: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 65_537 + rank)
        v = self.mc.vocab_size
        first = rng.integers(0, v, size=(n, 1))
        toks = [first]
        prev = first
        for t in range(length - 1):
            # deterministic bigram with noise: learnable structure
            nxt = (prev * 31 + self.shift[prev % 257]) % v
            noise = rng.random(size=prev.shape) < 0.15
            rand = rng.integers(0, v, size=prev.shape)
            prev = np.where(noise, rand, nxt)
            toks.append(prev)
        return np.concatenate(toks, axis=1).astype(np.int32)

    def batch(self, step: int, dp_rank: int = 0, dp_size: int = 1) -> dict:
        n = self.cfg.global_batch // dp_size
        length = self.cfg.seq_len + 1
        toks = self._tokens(step, dp_rank, n, length)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if self.mc.frontend == "audio_frames":
            rng = np.random.default_rng(step * 97 + dp_rank)
            out = {
                "frames": rng.standard_normal(
                    (n, self.cfg.seq_len, self.mc.d_model)).astype(np.float32),
                "labels": out["labels"] % self.mc.vocab_size,
            }
        elif self.mc.frontend == "vision_patches":
            rng = np.random.default_rng(step * 89 + dp_rank)
            out["media"] = rng.standard_normal(
                (n, self.mc.n_media_tokens, self.mc.d_model)).astype(np.float32)
        return out

    def global_batch(self, step: int) -> dict:
        return self.batch(step, 0, 1)
