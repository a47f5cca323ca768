"""Batched serving entry point of the port: prefill a batch of prompts
through the kernels, then decode greedily with the KV/SSM cache; or, for
an encoder-only model, one inference forward over a batch of frames.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --smoke --device cpu --prompt-len 32 --gen 32 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hubert-xlarge \\
        --smoke --device cpu --prompt-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --smoke --device cpu --model 2

Counterpart of ``repro/launch/serve.py``: the prompts are the
reference's (the same ``SyntheticStream``), and the cache is sized at
``max_seq`` from the start (the reference prefills a prompt-length cache
and grows it).  ``mesh=None`` is one device; on a ``compat.NodeMesh``
of ("data", "model") each rank calls ``serve`` with its own slice of the
weights (cut from the full tree by ``sharding.shard_tree``, a ``dp_mode="fsdp"`` config's FSDP leaves cut
over ``"data"`` too) through the
step builders of ``launch/steps.py``: tensor-parallel over ``"model"``,
the batch split over the dp ranks where it splits (else every dp rank
serves all of it), the KV cache cut on its positions over ``"model"``
(over ``("data", "model")`` where the batch does not split;
``max_seq`` rounded up to split), and every rank returns the tokens
gathered over the dp ranks.  ``main``'s ``--data`` / ``--model`` spawn
that many gloo ranks on the device (``compat.spawn_nodes``).  ``device=None`` is the
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
import os
import pickle
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.engine import tree_flatten
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.kernels.backend import (check_impl, launch_counts,
                                        resolve_device)
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import dp_axes_of, make_host_mesh
from repro_torch.models import model as M
from repro_torch.runtime import compat


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _greedy(cfg, logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None]


def _params(cfg, params, seed: int, dev: torch.device, mesh=None):
    """The served weights in the compute dtype: ``params`` (on a mesh,
    this rank's slice) cast, or a fresh draw from ``seed`` on the
    device, cast as it is drawn and, on a mesh, cut to this rank's
    slice."""
    if params is None:
        gen_ = torch.Generator(device=dev)
        gen_.manual_seed(seed)
        params = M.init_params(cfg, gen_, cast=True)
        if mesh is not None:
            params = SH.shard_tree(cfg, params, mesh,
                                   fsdp=ST.fsdp_axis(cfg, mesh))
    return M.cast_params(cfg, params)


def prompt_batch(cfg, batch: int, seq_len: int, seed: int,
                 dev: torch.device, mesh=None) -> dict:
    """The stream's first batch without its labels (tokens, or an audio
    model's frames; a vision model's media beside its tokens), on the
    device: the reference's ``prompt_batch``.  On a mesh, this rank's
    rows where the batch splits over the dp ranks."""
    stream = SyntheticStream(DataConfig(seq_len=seq_len, global_batch=batch,
                                        seed=seed), cfg)
    rows = _rows(batch, mesh)
    return {k: torch.from_numpy(v[rows].copy()).to(dev)
            for k, v in stream.global_batch(0).items() if k != "labels"}


def _rows(batch: int, mesh) -> slice:
    """This rank's rows of the batch: its block over the dp ranks where
    the batch splits, else all of them."""
    if mesh is None or not SH.batch_splits(batch, mesh):
        return slice(None)
    n = SH.dp_extent(mesh)
    i = compat.flat_node_id(mesh, dp_axes_of(mesh))
    return slice(i * (batch // n), (i + 1) * (batch // n))


def _gather_rows(t: torch.Tensor, batch: int, mesh) -> torch.Tensor:
    """Every dp rank's rows of ``t`` (a CPU tensor), in batch order."""
    if mesh is None or not SH.batch_splits(batch, mesh) \
            or SH.dp_extent(mesh) == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(SH.dp_extent(mesh))]
    dist.all_gather(parts, t.contiguous(),
                    group=ST.axes_group(mesh, dp_axes_of(mesh)))
    return torch.cat(parts)


def _launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def serve(cfg, mesh=None, *, batch: int, prompt_len: int, gen: int,
          max_seq: int = 0, seed: int = 0, params=None, device=None,
          kernel_impl: Optional[str] = None) -> dict:
    """Greedy generation of ``gen`` tokens after ``batch`` prompts of
    ``prompt_len`` tokens.  ``params`` (float32 master weights, as
    ``M.init_params`` makes them, or already cast; on a ``mesh``, where
    every rank calls ``serve``, this rank's slice as
    ``sharding.shard_tree`` cuts it) default to a fresh draw from
    ``seed`` on the device, cast as it is drawn.  Returns the
    tokens (numpy (batch, gen), gathered over the dp ranks), the prefill
    and decode seconds (host clock, ending in a device synchronise), the
    decode rate, this rank's cache bytes and its CUDA kernel launches of
    each phase."""
    check_impl(kernel_impl)
    dev = resolve_device(device)
    if not cfg.decoder:
        raise ValueError(f"{cfg.name} is encoder-only (no decode)")
    # the cache's positions split over the cut's ranks
    max_seq = ST.cache_len(max_seq or (prompt_len + gen), batch, mesh)
    prefill_fn, _ = ST.build_prefill_step(
        cfg, mesh, ShapeConfig("serve_pre", prompt_len, batch, "prefill"),
        max_seq=max_seq, impl=kernel_impl)
    decode_fn, _ = ST.build_decode_step(
        cfg, mesh, ShapeConfig("serve", max_seq, batch, "decode"))
    params = _params(cfg, params, seed, dev, mesh)
    prompts = prompt_batch(cfg, batch, prompt_len, seed, dev, mesh)

    _sync(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    after_prefill = launch_counts()

    tok = _greedy(cfg, logits)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode_fn(params, cache, tok, prompt_len + i)
        tok = _greedy(cfg, logits)
        out_tokens.append(tok)
    toks = torch.cat(out_tokens, dim=1).cpu()
    _sync(dev)
    t_decode = time.perf_counter() - t0
    end = launch_counts()
    toks = _gather_rows(toks, batch, mesh).numpy()
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_flatten(cache)[0])
    return {"tokens": toks, "t_prefill_s": t_prefill, "t_decode_s": t_decode,
            "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
            "cache_bytes": cache_bytes,
            "launches": {"prefill": _launch_delta(before, after_prefill),
                         "decode": _launch_delta(after_prefill, end)}}


def encode(cfg, mesh=None, *, batch: int, seq_len: int, seed: int = 0,
           params=None, device=None, kernel_impl: Optional[str] = None
           ) -> dict:
    """One inference forward of an encoder-only model over the stream's
    ``batch`` rows of ``seq_len`` frames.  ``params`` and ``mesh`` as for
    ``serve``.  Returns the logits (batch, seq_len, Vp; on a mesh this
    rank's rows), the seconds (host clock, ending in a device
    synchronise) and this rank's CUDA kernel launches."""
    check_impl(kernel_impl)
    dev = resolve_device(device)
    if cfg.decoder:
        raise ValueError(f"{cfg.name} is a decoder: serve it")
    step, _ = ST.build_prefill_step(
        cfg, mesh, ShapeConfig("encode", seq_len, batch, "prefill"),
        impl=kernel_impl)
    params = _params(cfg, params, seed, dev, mesh)
    frames = prompt_batch(cfg, batch, seq_len, seed, dev, mesh)
    _sync(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    logits = step(params, frames)
    _sync(dev)
    return {"logits": logits, "t_s": time.perf_counter() - t0,
            "launches": _launch_delta(before, launch_counts())}


def _rank_main(rank: int, data: int, model: int, cfg, kw: dict,
               out_path: str) -> None:
    mesh = make_host_mesh(data=data, model=model)
    fn = serve if cfg.decoder else encode
    out = fn(cfg, mesh, **kw)
    if rank == 0:
        if "logits" in out:
            out["logits"] = out["logits"].float().cpu().numpy()
        with open(out_path, "wb") as f:
            pickle.dump(out, f)


def run_mesh(cfg, data: int, model: int, timeout_s: float = 900.0,
             **kw) -> dict:
    """``serve`` (an encoder: ``encode``) on a (data, model) mesh of
    ``data * model`` spawned gloo ranks; rank 0's result."""
    with tempfile.TemporaryDirectory(prefix="repro-serve-") as tmp:
        out_path = os.path.join(tmp, "rank0.pkl")
        compat.spawn_nodes(_rank_main, data * model, data, model, cfg, kw,
                           out_path, timeout_s=timeout_s)
        with open(out_path, "rb") as f:
            return pickle.load(f)


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
    ap.add_argument("--data", type=int, default=1,
                    help="dp ranks of the mesh (spawned gloo ranks)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel ranks of the mesh")
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    kw = dict(batch=args.batch, device=args.device)
    if cfg.decoder:
        kw.update(prompt_len=args.prompt_len, gen=args.gen)
    else:
        kw.update(seq_len=args.prompt_len)
    if args.data * args.model > 1:
        print(f"mesh: data={args.data} model={args.model}")
        out = run_mesh(cfg, args.data, args.model, **kw)
    else:
        out = (serve if cfg.decoder else encode)(cfg, **kw)
    if not cfg.decoder:
        print(f"encode {out['t_s']:.2f}s, logits "
              f"{tuple(out['logits'].shape)}")
        return
    print(f"prefill {out['t_prefill_s']:.2f}s, "
          f"decode {out['t_decode_s']:.2f}s ({out['tok_per_s']:.1f} tok/s)")
    print("sample tokens:", out["tokens"][0, :16])


if __name__ == "__main__":
    main()
