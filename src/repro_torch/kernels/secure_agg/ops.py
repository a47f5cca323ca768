"""Dispatch layer for the secure-aggregation hot path.

Counterpart of ``repro/kernels/secure_agg/ops.py``.  Every protocol stage
calls one of the ``*_fn`` ops; :func:`repro_torch.kernels.backend.resolve`
picks the CUDA kernel for a CUDA tensor and the plain version
(``ref.py``) for a CPU tensor or an explicit ``impl="torch"``.

Each CUDA kernel has a launch counter (:class:`backend.Kernel`): its
wrapper adds one where it launches the kernel and nowhere else, so a run
can show that the main path went through the kernels.  A wrapper checks
device, dtype, shape and contiguity, allocates its output with
``torch.empty``, launches on the current stream and raises on a non-zero
launch status.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.backend import MASK, UNMASK, VOTE
from repro_torch.kernels.secure_agg import ref as R
from repro_torch.kernels.secure_agg.secure_agg import as_copy_list, narrow
from repro_torch.roofline import counts

_MASK_MODES = {"quantize": 0, "mask": 1, "pairwise": 2}
_UNMASK_MODES = {"dequantize": 0, "mask": 1}
MAX_COPIES = 31          # largest vote redundancy: MAX_COPIES in csrc


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _words(B: int, v, device: torch.device) -> torch.Tensor:
    """Per-row uint32 metadata -> contiguous (B,) int32 words on device."""
    if (isinstance(v, torch.Tensor) and v.dtype == torch.int32
            and v.device == device and v.numel() == B):
        return v.reshape(B).contiguous()
    return narrow(R.row_meta(B, v, device).reshape(B)).contiguous()


def _mask_cuda(x, node_ids, seeds, scale, clip, mode, offsets,
               cluster_size) -> torch.Tensor:
    backend.check_tensor(x, torch.float32, 2, "x")
    if mode not in _MASK_MODES:
        raise ValueError(f"unknown mask mode {mode!r}")
    if mode == "pairwise" and cluster_size < 1:
        raise ValueError("pairwise mode needs cluster_size >= 1")
    B, T = x.shape
    dev = x.device
    out = torch.empty((B, T), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    sd = _words(B, seeds, dev)
    nid = _words(B, node_ids, dev)
    off = _words(B, 0 if offsets is None else offsets, dev)
    with torch.cuda.device(dev):
        rc = build.lib().sa_mask_encrypt(
            x.data_ptr(), sd.data_ptr(), nid.data_ptr(), off.data_ptr(),
            out.data_ptr(), B, T, R.f32(scale), R.f32(clip),
            _MASK_MODES[mode], int(cluster_size), backend.stream(dev))
    backend.raise_on(rc, MASK.name)
    MASK.launches += 1
    return out


def _unmask_cuda(agg, n_nodes, seeds, scale, mode, offsets) -> torch.Tensor:
    backend.check_tensor(agg, torch.int32, 2, "agg")
    if mode not in _UNMASK_MODES:
        raise ValueError(f"unknown unmask mode {mode!r}")
    B, T = agg.shape
    dev = agg.device
    out = torch.empty((B, T), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    sd = _words(B, seeds, dev)
    off = _words(B, 0 if offsets is None else offsets, dev)
    with torch.cuda.device(dev):
        rc = build.lib().sa_unmask_decrypt(
            agg.data_ptr(), sd.data_ptr(), off.data_ptr(), out.data_ptr(),
            B, T, int(n_nodes), R.f32(scale), _UNMASK_MODES[mode],
            backend.stream(dev))
    backend.raise_on(rc, UNMASK.name)
    UNMASK.launches += 1
    return out


def _vote_cuda(copies: list, acc: torch.Tensor) -> torch.Tensor:
    r = len(copies)
    if r % 2 != 1 or r > MAX_COPIES:
        raise ValueError(f"vote redundancy must be odd and <= {MAX_COPIES}, "
                         f"got {r}")
    backend.check_tensor(acc, torch.int32, 1, "acc")
    for c in copies:
        backend.check_tensor(c, torch.int32, 1, "vote copy")
        if c.shape != acc.shape or c.device != acc.device:
            raise ValueError("vote copies must match acc's shape and device")
    dev = acc.device
    out = torch.empty_like(acc)
    if out.numel() == 0:
        return out
    ptrs = (ctypes.c_void_p * r)(*[c.data_ptr() for c in copies])
    with torch.cuda.device(dev):
        rc = build.lib().sa_vote_combine(ptrs, r, acc.data_ptr(),
                                         out.data_ptr(), acc.numel(),
                                         backend.stream(dev))
    backend.raise_on(rc, VOTE.name)
    VOTE.launches += 1
    return out


# ---------------------------------------------------------------------------
# The ops the engine calls
# ---------------------------------------------------------------------------


def mask_encrypt_batch_fn(x, node_ids, seeds, scale: float, clip: float,
                          mode: str = "mask", offsets=None,
                          cluster_size: int = 0,
                          impl: Optional[str] = None) -> torch.Tensor:
    """(B, T) float32 rows -> (B, T) int32 words, row b keyed by
    (seeds[b], node_ids[b]) at counter offset ``offsets[b]``."""
    route = backend.resolve(impl, x)
    if route == "meta":
        nbytes, int_ops, flops = counts.mask_work(*x.shape)
        backend.record_meta(MASK, nbytes, flops, int_ops)
        return torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if route == "cuda":
        return _mask_cuda(x, node_ids, seeds, scale, clip, mode, offsets,
                          cluster_size)
    return R.mask_encrypt_batch_ref(x, node_ids, seeds, scale, clip,
                                    mode=mode, offsets=offsets,
                                    cluster_size=cluster_size)


def unmask_decrypt_batch_fn(agg, n_nodes: int, seeds, scale: float,
                            mode: str = "mask", offsets=None,
                            impl: Optional[str] = None) -> torch.Tensor:
    """(B, T) int32-word aggregates -> (B, T) float32 decryptions."""
    route = backend.resolve(impl, agg)
    if route == "meta":
        nbytes, int_ops, flops = counts.unmask_work(*agg.shape, n_nodes)
        backend.record_meta(UNMASK, nbytes, flops, int_ops)
        return torch.empty(agg.shape, dtype=torch.float32, device=agg.device)
    if route == "cuda":
        return _unmask_cuda(agg, n_nodes, seeds, scale, mode, offsets)
    return R.unmask_decrypt_batch_ref(agg, n_nodes, seeds, scale, mode=mode,
                                      offsets=offsets)


def vote_combine_fn(copies: Union[torch.Tensor, Sequence[torch.Tensor]],
                    acc, impl: Optional[str] = None) -> torch.Tensor:
    """acc + majority(copies) over flat int32-word tensors."""
    copies = as_copy_list(copies)
    route = backend.resolve(impl, acc)
    if route == "meta":
        nbytes, int_ops, flops = counts.vote_work(len(copies), acc.numel())
        backend.record_meta(VOTE, nbytes, flops, int_ops)
        return torch.empty(acc.shape, dtype=acc.dtype, device=acc.device)
    if route == "cuda":
        return _vote_cuda(copies, acc)
    return R.vote_combine_ref(copies, acc)


def vote_combine_batch_fn(copies: Sequence[torch.Tensor], acc,
                          impl: Optional[str] = None) -> torch.Tensor:
    """acc + majority(copies) over (B, T) rows; the vote is elementwise,
    so the batch flattens into one launch of the flat kernel."""
    copies = [c.reshape(-1) for c in as_copy_list(copies)]
    return vote_combine_fn(copies, acc.reshape(-1),
                           impl=impl).reshape(acc.shape)


def mask_encrypt_fn(x, node_id, seed, scale: float, clip: float,
                    mode: str = "mask", offset=0, cluster_size: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Single-row form: (T,) float32 -> (T,) int32 words (B = 1)."""
    return mask_encrypt_batch_fn(x[None], node_id, seed, scale, clip,
                                 mode=mode, offsets=offset,
                                 cluster_size=cluster_size, impl=impl)[0]


def unmask_decrypt_fn(agg, n_nodes: int, seed, scale: float,
                      mode: str = "mask", offset=0,
                      impl: Optional[str] = None) -> torch.Tensor:
    """Single-row form: (T,) int32 words -> (T,) float32 (B = 1)."""
    return unmask_decrypt_batch_fn(agg[None], n_nodes, seed, scale,
                                   mode=mode, offsets=offset, impl=impl)[0]
