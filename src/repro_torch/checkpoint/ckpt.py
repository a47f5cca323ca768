"""Checkpointing with an atomic write, an integrity manifest, an optional
asynchronous writer and restart.

Counterpart of ``repro/checkpoint/ckpt.py``, in the same layout, so
either package reads the other's checkpoints of the same tree:

    <dir>/step_<N:08d>/
        manifest.json   {step, leaves: [{file, name, shape, dtype, hash}]}
        leaf_<i>.npy    one file per leaf, in flattening order (dict keys
                        sorted, lists in order, as jax flattens)

  * the write goes to ``step_<N>.tmp`` and is renamed, so a crash
    mid-write never leaves a torn ``step_<N>``;
  * ``latest_step`` / ``restore`` pick the newest complete checkpoint;
  * a blake2b hash of each leaf's bytes is checked on load;
  * bfloat16 leaves are stored as their uint16 bit pattern (numpy has no
    bfloat16), with ``"dtype": "bfloat16"`` in the manifest.

The reference's elastic restore onto new shardings becomes a restore
onto a given device and, for floating-point leaves, a given dtype.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

_NATIVE_NUMPY = {"float64", "float32", "float16", "int64", "int32", "int16",
                 "int8", "uint64", "uint32", "uint16", "uint8", "bool"}


class CheckpointError(RuntimeError):
    """A checkpoint that does not match its manifest or the tree it is
    restored into."""


def _named_leaves(tree: Any, prefix: str = "") -> list:
    """(jax-style key path, leaf) pairs in jax's flattening order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _named_leaves(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _named_leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(tree: Any, leaves: list) -> Any:
    """``tree``'s structure with ``leaves`` in flattening order."""
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return next(it)

    return go(tree)


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` and its dtype name (bf16 as its bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _digest(arr: np.ndarray) -> str:
    return hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest()


def save(ckpt_dir: str, step: int, tree: Any, *, asynchronous: bool = False
         ) -> Optional[threading.Thread]:
    """Copies every leaf to the host now, then writes atomically (on a
    thread with ``asynchronous``, whose handle is returned: join it)."""
    named = [(name, *_to_numpy(leaf)) for name, leaf in _named_leaves(tree)]

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for i, (name, arr, dt) in enumerate(named):
            fn = f"leaf_{i}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append({
                "file": fn, "name": name, "shape": list(arr.shape),
                "dtype": dt, "hash": _digest(arr)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if asynchronous:
        th = threading.Thread(target=_write, daemon=True)
        th.start()
        return th
    _write()
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step with a complete checkpoint (its manifest written
    and the directory renamed from ``.tmp``), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, dt: str) -> torch.Tensor:
    # a copy, not ascontiguousarray, which turns a 0-d leaf into 1-d
    if dt in _NATIVE_NUMPY:
        return torch.from_numpy(arr.copy())
    if dt == "bfloat16":
        return torch.from_numpy(arr.copy().view(np.int16)
                                ).view(torch.bfloat16)
    raise CheckpointError(f"no torch dtype for a {dt} leaf")


def restore(ckpt_dir: str, step: int, like: Any, device=None,
            dtype: Optional[torch.dtype] = None, *, verify: bool = True
            ) -> Any:
    """The checkpoint of ``step`` in the structure of ``like``.  Each leaf
    goes to ``device`` (default: the device of ``like``'s leaf) in its
    stored dtype, or in ``dtype`` where that is given and the leaf is
    floating-point."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    refs = [leaf for _, leaf in _named_leaves(like)]
    if len(refs) != len(manifest["leaves"]):
        raise CheckpointError(f"leaf count mismatch: {len(refs)} vs "
                              f"{len(manifest['leaves'])}")
    out = []
    for meta, ref in zip(manifest["leaves"], refs):
        arr = np.load(os.path.join(d, meta["file"]))
        if verify and _digest(arr) != meta["hash"]:
            raise CheckpointError(f"checkpoint corruption in {meta['name']}")
        t = _from_numpy(arr, meta["dtype"])
        dev = device if device is not None else ref.device
        to = dtype if dtype is not None and t.is_floating_point() else t.dtype
        out.append(t.to(device=dev, dtype=to))
    return _rebuild(like, out)
