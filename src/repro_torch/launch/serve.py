"""Batched serving entry point of the port: prefill a batch of prompts
through the kernels, then decode greedily with the KV/SSM cache; or, for
an encoder-only model, one inference forward over a batch of frames.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --smoke --device cpu --prompt-len 32 --gen 32 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hubert-xlarge \\
        --smoke --device cpu --prompt-len 64

Counterpart of ``repro/launch/serve.py`` on one device: the prompts are
the reference's (the same ``SyntheticStream``), the cache is sized at
``max_seq`` from the start (the reference prefills a prompt-length cache
and grows it), and the reference's ``mesh`` has no counterpart yet (the
sharded serve comes with the distributed slice).  ``device=None`` is the
card and raises without one.  Every registered decoder serves, the MoE
ones included: a decode step sends its B tokens through the MoE with the
capacity of B tokens (at least 8 slots an expert), as the reference's; a
cross-attention model's prompts carry the stream's media, whose K / V the
prefill caches (``cfg.n_media_tokens`` of them) for every decode step.
An encoder-only model (hubert-xlarge) has no decode: ``serve`` raises,
as the reference's does, and ``encode`` is the counterpart of the
reference's encoder-only prefill step (``build_prefill_step``: the
inference forward, whose output is the logits).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.kernels.backend import (check_impl, launch_counts,
                                        resolve_device)
from repro_torch.models import model as M


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _greedy(cfg, logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None]


def _params(cfg, params, seed: int, dev: torch.device):
    """The served weights in the compute dtype: ``params`` cast, or a
    fresh draw from ``seed`` on the device, cast as it is drawn."""
    if params is None:
        gen_ = torch.Generator(device=dev)
        gen_.manual_seed(seed)
        params = M.init_params(cfg, gen_, cast=True)
    return M.cast_params(cfg, params)


def prompt_batch(cfg, batch: int, seq_len: int, seed: int,
                 dev: torch.device) -> dict:
    """The stream's first batch without its labels (tokens, or an audio
    model's frames; a vision model's media beside its tokens), on the
    device: the reference's ``prompt_batch``."""
    stream = SyntheticStream(DataConfig(seq_len=seq_len, global_batch=batch,
                                        seed=seed), cfg)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in stream.global_batch(0).items() if k != "labels"}


def _launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def serve(cfg, *, batch: int, prompt_len: int, gen: int, max_seq: int = 0,
          seed: int = 0, params=None, device=None,
          kernel_impl: Optional[str] = None) -> dict:
    """Greedy generation of ``gen`` tokens after ``batch`` prompts of
    ``prompt_len`` tokens.  ``params`` (float32 master weights, as
    ``M.init_params`` makes them, or already cast) default to a fresh
    draw from ``seed`` on the device, cast as it is drawn.  Returns the
    tokens (numpy (batch, gen)), the prefill and decode seconds (host
    clock, ending in a device synchronise), the decode rate, and the CUDA
    kernel launches of each phase."""
    check_impl(kernel_impl)
    dev = resolve_device(device)
    if not cfg.decoder:
        raise ValueError(f"{cfg.name} is encoder-only (no decode)")
    max_seq = max_seq or (prompt_len + gen)
    params = _params(cfg, params, seed, dev)
    prompts = prompt_batch(cfg, batch, prompt_len, seed, dev)

    _sync(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, prompts, max_seq,
                              impl=kernel_impl)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    after_prefill = launch_counts()

    tok = _greedy(cfg, logits)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = M.decode_step(cfg, params, cache, tok, prompt_len + i)
        tok = _greedy(cfg, logits)
        out_tokens.append(tok)
    toks = torch.cat(out_tokens, dim=1).cpu().numpy()
    _sync(dev)
    t_decode = time.perf_counter() - t0
    end = launch_counts()
    return {"tokens": toks, "t_prefill_s": t_prefill, "t_decode_s": t_decode,
            "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
            "launches": {"prefill": _launch_delta(before, after_prefill),
                         "decode": _launch_delta(after_prefill, end)}}


def encode(cfg, *, batch: int, seq_len: int, seed: int = 0, params=None,
           device=None, kernel_impl: Optional[str] = None) -> dict:
    """One inference forward of an encoder-only model over the stream's
    ``batch`` rows of ``seq_len`` frames.  ``params`` as for ``serve``.
    Returns the logits (batch, seq_len, Vp), the seconds (host clock,
    ending in a device synchronise) and the CUDA kernel launches."""
    check_impl(kernel_impl)
    dev = resolve_device(device)
    if cfg.decoder:
        raise ValueError(f"{cfg.name} is a decoder: serve it")
    params = _params(cfg, params, seed, dev)
    frames = prompt_batch(cfg, batch, seq_len, seed, dev)
    _sync(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    logits = M.forward(cfg, params, frames, impl=kernel_impl)
    _sync(dev)
    return {"logits": logits, "t_s": time.perf_counter() - t0,
            "launches": _launch_delta(before, launch_counts())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="prompt tokens (an encoder's frames)")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card")
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.decoder:
        out = encode(cfg, batch=args.batch, seq_len=args.prompt_len,
                     device=args.device)
        print(f"encode {out['t_s']:.2f}s, logits "
              f"{tuple(out['logits'].shape)}")
        return
    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, device=args.device)
    print(f"prefill {out['t_prefill_s']:.2f}s, "
          f"decode {out['t_decode_s']:.2f}s ({out['tok_per_s']:.1f} tok/s)")
    print("sample tokens:", out["tokens"][0, :16])


if __name__ == "__main__":
    main()
