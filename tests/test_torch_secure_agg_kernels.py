"""The port's plain kernel versions against the JAX package, bit for bit.

The same numpy inputs go through ``repro.kernels.secure_agg.ops`` (the
Pallas kernels in interpret mode at small T, the jnp engine at large T)
and through ``repro_torch.kernels.secure_agg.ops`` on CPU tensors, which
run the plain torch versions.  uint32 words and float32 results are
compared with ``np.array_equal``: the reference pins these stages bit for
bit, so there is no tolerance.  The CUDA kernels are held against the
same plain versions on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.secure_agg import ops as J
from repro_torch.convert import words_from_numpy, words_to_numpy
from repro_torch.kernels.backend import KERNELS, launch_counts
from repro_torch.kernels.secure_agg import ops as P

CASES = ([(T, "pallas_interpret") for T in (1, 77, 1025)]
         + [(T, "jnp") for T in (8193, 100003)])
SCALE, CLIP = 2.0 ** 20, 1.0
OFFSETS = np.array([0, 2 ** 32 - 50, 12345], np.uint32)   # counter wrap


def _payload(rng, B, T):
    """Normal values plus the edges: exact .5 products (round half to
    even), +-clip, beyond clip."""
    x = (rng.normal(size=(B, T)) * 0.7).astype(np.float32)
    edges = np.array([0.5, 1.5, -0.5, -2.5, 3.5], np.float32) / SCALE
    edges = np.concatenate([edges, [CLIP, -CLIP, 1.7, -3.0, 0.0]])
    k = min(T, edges.size)
    x[:, :k] = edges[:k].astype(np.float32)
    return x


@pytest.mark.parametrize("mode,c", [("mask", 0), ("quantize", 0),
                                    ("pairwise", 2), ("pairwise", 4)])
@pytest.mark.parametrize("T,impl", CASES)
def test_mask_encrypt_batch_matches_reference(T, impl, mode, c):
    rng = np.random.default_rng(T + 31 * c)
    B = 3
    x = _payload(rng, B, T)
    node_ids = np.array([0, 5, 6], np.uint32)
    seeds = rng.integers(0, 2 ** 32, size=B, dtype=np.uint32)
    want = np.asarray(J.mask_encrypt_batch_fn(
        jnp.asarray(x), jnp.asarray(node_ids), jnp.asarray(seeds), SCALE,
        CLIP, mode=mode, offsets=jnp.asarray(OFFSETS), cluster_size=c,
        impl=impl))
    got = P.mask_encrypt_batch_fn(torch.from_numpy(x), node_ids, seeds,
                                  SCALE, CLIP, mode=mode, offsets=OFFSETS,
                                  cluster_size=c)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, T)
    assert np.array_equal(words_to_numpy(got), want)
    # the single-row form is the B = 1 case
    one = P.mask_encrypt_fn(torch.from_numpy(x[1]), 5, int(seeds[1]), SCALE,
                            CLIP, mode=mode, offset=int(OFFSETS[1]),
                            cluster_size=c)
    assert np.array_equal(words_to_numpy(one), want[1])


# NaN, +-Inf and -0.0 rows: XLA converts NaN to int 0, so the reference
# quantizes NaN to 0 and +-Inf to +-clip; -0.0 quantizes to 0
NONFINITE = np.array([np.nan, np.inf, -np.inf, -0.0, 0.25, np.nan, -np.inf,
                      np.inf], np.float32)


@pytest.mark.parametrize("mode,c", [("mask", 0), ("quantize", 0),
                                    ("pairwise", 2), ("pairwise", 4)])
@pytest.mark.parametrize("impl", ["pallas_interpret", "jnp"])
def test_mask_encrypt_nonfinite_rows_match_reference(impl, mode, c):
    x = np.stack([NONFINITE, NONFINITE[::-1].copy(),
                  np.full(8, np.nan, np.float32)])
    node_ids = np.array([0, 5, 6], np.uint32)
    seeds = np.array([7, 8, 9], np.uint32)
    want = np.asarray(J.mask_encrypt_batch_fn(
        jnp.asarray(x), jnp.asarray(node_ids), jnp.asarray(seeds), SCALE,
        CLIP, mode=mode, offsets=jnp.asarray(OFFSETS), cluster_size=c,
        impl=impl))
    got = P.mask_encrypt_batch_fn(torch.from_numpy(x), node_ids, seeds,
                                  SCALE, CLIP, mode=mode, offsets=OFFSETS,
                                  cluster_size=c)
    assert np.array_equal(words_to_numpy(got), want)
    if mode == "quantize":
        q = words_to_numpy(got).view(np.int32)
        assert (q[2] == 0).all()                       # NaN -> 0
        assert q[0].tolist()[:4] == [0, int(SCALE), -int(SCALE), 0]


@pytest.mark.parametrize("mode,n", [("mask", 1), ("mask", 4), ("mask", 64),
                                    ("dequantize", 64)])
@pytest.mark.parametrize("T,impl", CASES)
def test_unmask_decrypt_batch_matches_reference(T, impl, mode, n):
    rng = np.random.default_rng(3 * T + n)
    B = 3
    agg = rng.integers(0, 2 ** 32, size=(B, T), dtype=np.uint32)
    seeds = rng.integers(0, 2 ** 32, size=B, dtype=np.uint32)
    want = np.asarray(J.unmask_decrypt_batch_fn(
        jnp.asarray(agg), n, jnp.asarray(seeds), SCALE, mode=mode,
        offsets=jnp.asarray(OFFSETS), impl=impl))
    got = P.unmask_decrypt_batch_fn(words_from_numpy(agg), n, seeds, SCALE,
                                    mode=mode, offsets=OFFSETS)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    one = P.unmask_decrypt_fn(words_from_numpy(agg[2]), n, int(seeds[2]),
                              SCALE, mode=mode, offset=int(OFFSETS[2]))
    assert np.array_equal(one.numpy(), want[2])


@pytest.mark.parametrize("majority", [True, False])
@pytest.mark.parametrize("r", [1, 3, 5])
@pytest.mark.parametrize("T,impl", CASES)
def test_vote_combine_batch_matches_reference(T, impl, r, majority):
    """Random copies with no majority pin the unsigned order of the
    median (signed order differs whenever copies straddle 2^31)."""
    rng = np.random.default_rng(5 * T + r)
    B = 2
    copies = [rng.integers(0, 2 ** 32, size=(B, T), dtype=np.uint32)
              for _ in range(r)]
    if majority:
        for s in range(r // 2 + 1):
            copies[s] = copies[0]
    acc = rng.integers(0, 2 ** 32, size=(B, T), dtype=np.uint32)
    want = np.asarray(J.vote_combine_batch_fn(
        [jnp.asarray(c) for c in copies], jnp.asarray(acc), impl=impl))
    got = P.vote_combine_batch_fn([words_from_numpy(c) for c in copies],
                                  words_from_numpy(acc))
    assert np.array_equal(words_to_numpy(got), want)
    if majority:
        assert np.array_equal(words_to_numpy(got), acc + copies[0])


def test_cpu_tensor_with_cuda_impl_raises():
    """A CUDA kernel is never asked to run on a CPU tensor, and an
    unknown engine name is refused."""
    x = torch.zeros((1, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.mask_encrypt_batch_fn(x, 0, 0, SCALE, CLIP, impl="cuda")
    with pytest.raises(ValueError, match="not in"):
        P.mask_encrypt_batch_fn(x, 0, 0, SCALE, CLIP, impl="pallas")
    assert launch_counts() == {k.name: 0 for k in KERNELS}
    assert {"mask_encrypt", "unmask_decrypt", "vote_combine",
            "mont_mul"} <= set(launch_counts())
