"""The port's ``core.byzantine.majority_vote`` and ``majority_vote_list``
against the JAX package's, on the inputs of the reference's
``tests/test_vote_schedules.py::test_vote_corrects_any_minority`` (r in
{3, 5, 7} copies of 64 words, fewer than half corrupted, seeds drawn as
there) and ``tests/test_secure_agg_kernels.py::
test_vote_combine_kernel_matches_jnp`` (r in {1, 3, 5} copies of T in
{1, 77, 1000} words): every result bit-equal to the reference's, the
stacked and the list forms to each other and to the port's
``vote_combine_ref`` less its accumulator.  uint32 words cross as int32
words with the same bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.byzantine import majority_vote as j_vote
from repro.core.byzantine import majority_vote_list as j_vote_list
from repro_torch.core.byzantine import majority_vote, majority_vote_list
from repro_torch.kernels.secure_agg.ref import vote_combine_ref


def _words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _uint(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 7, 123, 9_999])
@pytest.mark.parametrize("r", [3, 5, 7])
def test_vote_corrects_any_minority(r, seed):
    rng = np.random.default_rng(seed)
    honest = rng.integers(0, 2 ** 32, size=(64,), dtype=np.uint32)
    n_bad = rng.integers(0, (r - 1) // 2 + 1)
    copies = np.tile(honest, (r, 1))
    for b in rng.choice(r, size=n_bad, replace=False):
        copies[b] = rng.integers(0, 2 ** 32, size=(64,), dtype=np.uint32)
    got = majority_vote(_words(copies))
    np.testing.assert_array_equal(_uint(got), honest)
    np.testing.assert_array_equal(_uint(got),
                                  np.asarray(j_vote(jnp.asarray(copies))))
    np.testing.assert_array_equal(
        _uint(majority_vote_list([_words(c) for c in copies])), honest)


@pytest.mark.parametrize("r", [1, 3, 5])
@pytest.mark.parametrize("T", [1, 77, 1000])
def test_list_and_stacked_votes_equal_vote_combine(T, r):
    rng = np.random.default_rng(T * 10 + r)
    copies = [rng.integers(0, 2 ** 32, size=(T,), dtype=np.uint32)
              for _ in range(r)]
    acc = np.zeros((T,), np.uint32)
    listed = majority_vote_list([_words(c) for c in copies])
    stacked = majority_vote(_words(np.stack(copies)))
    assert torch.equal(listed, stacked)
    assert torch.equal(listed, vote_combine_ref([_words(c) for c in copies],
                                                _words(acc)))
    want = np.asarray(j_vote_list([jnp.asarray(c) for c in copies]))
    np.testing.assert_array_equal(_uint(listed), want)
    np.testing.assert_array_equal(
        want, np.asarray(j_vote(jnp.asarray(np.stack(copies)))))


def test_even_redundancy_raises():
    two = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="odd"):
        majority_vote(two)
    with pytest.raises(ValueError, match="odd"):
        majority_vote_list(list(two))
