"""The port's checkpoints: the cases of ``tests/test_checkpoint.py`` on
the port (round trip, async write, newest complete, corruption detected,
restore onto another dtype or device), and the shared layout: a
checkpoint written by the reference's ``ckpt.save`` is read by the
port's ``restore`` and the other way round, leaf for leaf and bit for
bit (bfloat16 leaves through their uint16 view)."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JCK
from repro_torch.checkpoint import ckpt as CK


def tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16) * 1.5,
                  "step": torch.tensor(7, dtype=torch.int32)},
            "units": [{"w": torch.full((2,), float(u))} for u in range(2)]}


def _zeros_like(t):
    return CK._rebuild(t, [torch.zeros_like(x) for _, x in
                           CK._named_leaves(t)])


def _leaves(t):
    return [x for _, x in CK._named_leaves(t)]


def test_roundtrip(tmp_path):
    t = tree()
    CK.save(str(tmp_path), 3, t)
    assert CK.latest_step(str(tmp_path)) == 3
    r = CK.restore(str(tmp_path), 3, _zeros_like(t))
    for a, b in zip(_leaves(t), _leaves(r)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(r["units"], list) and len(r["units"]) == 2


def test_async_save(tmp_path):
    th = CK.save(str(tmp_path), 5, tree(), asynchronous=True)
    th.join(timeout=60)
    assert not th.is_alive()
    assert CK.latest_step(str(tmp_path)) == 5


def test_latest_picks_newest_complete(tmp_path):
    CK.save(str(tmp_path), 1, tree())
    CK.save(str(tmp_path), 2, tree())
    # a torn write (crash mid-save) must be ignored
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert CK.latest_step(str(tmp_path)) == 2


def test_corruption_detected(tmp_path):
    CK.save(str(tmp_path), 1, tree())
    fn = tmp_path / "step_00000001" / "leaf_0.npy"
    np.save(fn, np.load(fn) + 1)
    with pytest.raises(CK.CheckpointError, match="corruption"):
        CK.restore(str(tmp_path), 1, tree())


def test_leaf_count_mismatch_raises(tmp_path):
    CK.save(str(tmp_path), 1, tree())
    with pytest.raises(CK.CheckpointError, match="leaf count"):
        CK.restore(str(tmp_path), 1, {"a": torch.zeros(1)})


def test_restore_onto_another_dtype_and_device(tmp_path):
    """The counterpart of the reference's elastic restore: each leaf onto
    a given device, floating-point leaves in a given dtype, integer
    leaves as stored."""
    t = tree()
    CK.save(str(tmp_path), 1, t)
    r = CK.restore(str(tmp_path), 1, t, device="meta", dtype=torch.float64)
    assert all(x.device.type == "meta" for x in _leaves(r))
    r = CK.restore(str(tmp_path), 1, t, dtype=torch.float64)
    assert r["a"].dtype == torch.float64 and r["b"]["step"].dtype == \
        torch.int32
    assert torch.equal(r["b"]["c"], t["b"]["c"].double())


def _jtree():
    return {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
            "b": {"c": jnp.ones((5,), jnp.bfloat16) * 1.5,
                  "step": jnp.int32(7)},
            "units": [{"w": jnp.full((2,), float(u))} for u in range(2)]}


def test_reads_a_reference_checkpoint(tmp_path):
    jt = _jtree()
    JCK.save(str(tmp_path), 4, jt)
    assert CK.latest_step(str(tmp_path)) == 4
    r = CK.restore(str(tmp_path), 4, tree())
    for got, want in zip(_leaves(r), jax.tree.leaves(jt)):
        want = np.asarray(want)
        if want.dtype == ml_dtypes.bfloat16:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_reference_reads_a_port_checkpoint(tmp_path):
    CK.save(str(tmp_path), 6, tree())
    jt = _jtree()
    assert JCK.latest_step(str(tmp_path)) == 6
    r = JCK.restore(str(tmp_path), 6, jt)
    for got, want in zip(jax.tree.leaves(r), _leaves(tree())):
        if want.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                np.asarray(got).view(np.uint16),
                want.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(np.asarray(got), want.numpy())
