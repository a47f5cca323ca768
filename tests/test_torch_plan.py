"""The port's plan layer against the JAX package: compiled hop rounds,
schedule costs, mask scales, digests, the fault model and the config
negatives, all equal to the reference's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import byzantine as JB
from repro.core import masking as JM
from repro.core import plan as JP
from repro.core import schedules as JS
from repro_torch.convert import words_from_numpy, words_to_numpy
from repro_torch.core import byzantine as TB
from repro_torch.core import masking as TM
from repro_torch.core import plan as TP
from repro_torch.core import schedules as TS

HOP_FIELDS = ("combine", "recv_from", "perms", "src_idx", "participates",
              "backup_perm", "backup_src")


@pytest.mark.parametrize("c,r", [(4, 3), (2, 1)])
@pytest.mark.parametrize("n", [4, 8, 16, 64])
@pytest.mark.parametrize("schedule", ["ring", "tree", "butterfly"])
def test_hop_rounds_equal_reference(schedule, n, c, r):
    kw = dict(n_nodes=n, cluster_size=c, redundancy=r, schedule=schedule)
    want = JP.compile_plan(JP.AggConfig(**kw))
    got = TP.compile_plan(TP.AggConfig(**kw))
    assert len(got.rounds) == len(want.rounds)
    for a, b in zip(got.rounds, want.rounds):
        for f in HOP_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
    assert got.groups == want.groups
    for T in (1, 96, 1 << 22):
        assert got.wire_bytes(T, S=3) == want.wire_bytes(T, S=3)


@pytest.mark.parametrize("digest,backup", [(False, False), (True, False),
                                           (True, True)])
@pytest.mark.parametrize("schedule,g", [("ring", 16), ("ring", 5),
                                        ("tree", 8), ("butterfly", 4)])
def test_schedule_cost_equals_reference(schedule, g, digest, backup):
    kw = dict(digest=digest, digest_backup=backup, digest_words=16)
    assert TS.schedule_cost(schedule, g, 4, 3, 4 << 20, **kw) == \
        JS.schedule_cost(schedule, g, 4, 3, 4 << 20, **kw)


@pytest.mark.parametrize("n,guard,clip", [(1, 2, 1.0), (16, 2, 2.0),
                                          (64, 2, 1.0), (1000, 3, 0.25)])
def test_mask_config_scale_equals_reference(n, guard, clip):
    a = TM.MaskConfig(n_nodes=n, guard_bits=guard, clip=clip)
    b = JM.MaskConfig(n_nodes=n, guard_bits=guard, clip=clip)
    assert (a.frac_bits, a.scale) == (b.frac_bits, b.scale)


@pytest.mark.parametrize("T,words", [(1, 16), (77, 16), (4096, 16),
                                     (1000, 7)])
def test_digest_equals_reference(T, words):
    rng = np.random.default_rng(T)
    x = rng.integers(0, 2 ** 32, size=(3, T), dtype=np.uint32)
    want = np.asarray(JB.digest_rows(jnp.asarray(x), words))
    got = words_to_numpy(TB.digest_rows(words_from_numpy(x), words))
    assert np.array_equal(got, want)
    assert np.array_equal(
        words_to_numpy(TB.digest(words_from_numpy(x[1]), words)),
        np.asarray(JB.digest(jnp.asarray(x[1]), words)))


@pytest.mark.parametrize("base", ["flip", "garbage", "drop", "equivocate",
                                  "mismatch"])
def test_fault_model_equals_reference(base):
    rng = np.random.default_rng(11)
    x = rng.integers(0, 2 ** 32, size=(2, 33), dtype=np.uint32)
    tx, jx = words_from_numpy(x), jnp.asarray(x)
    for view in ("payload", "digest"):
        assert np.array_equal(words_to_numpy(TB.sent_value(base, view, tx)),
                              np.asarray(JB.sent_value(base, view, jx)))
    for stream in range(5):
        assert np.array_equal(
            words_to_numpy(TB.equivocate_digest(tx, stream)),
            np.asarray(JB.equivocate_digest(jx, stream)))
        assert np.array_equal(
            words_to_numpy(TB.equivocate_payload(tx, stream)),
            np.asarray(JB.equivocate_payload(jx, stream)))
    assert TB.parse_mode(base + "@2") == JB.parse_mode(base + "@2")


def test_digest_vote_combine_equals_reference():
    rng = np.random.default_rng(2)
    payload = rng.integers(0, 2 ** 32, size=(4, 50), dtype=np.uint32)
    backup = rng.integers(0, 2 ** 32, size=(4, 50), dtype=np.uint32)
    base = rng.integers(0, 2 ** 32, size=(4, 50), dtype=np.uint32)
    honest = np.asarray(JB.digest_rows(jnp.asarray(payload)))
    wrong = honest ^ np.uint32(1)
    # rows 0-1 accepted (2 of 3 agree), rows 2-3 rejected
    copies = [honest, np.concatenate([honest[:2], wrong[2:]]), wrong]
    for bk in (backup, None):
        want = np.asarray(JB.digest_vote_combine(
            jnp.asarray(payload), [jnp.asarray(c) for c in copies],
            jnp.asarray(base),
            backup=None if bk is None else jnp.asarray(bk)))
        got = TB.digest_vote_combine(
            words_from_numpy(payload), [words_from_numpy(c) for c in copies],
            words_from_numpy(base),
            backup=None if bk is None else words_from_numpy(bk))
        assert np.array_equal(words_to_numpy(got), want)


# the reference's ConfigError negatives (tests/test_api.py); the port's
# invalid kernel engine is a reference name, since "cuda" is valid here
@pytest.mark.parametrize("kw,needle", [
    (dict(n_nodes=10, cluster_size=4), "multiple of cluster_size"),
    (dict(n_nodes=0), "n_nodes"),
    (dict(n_nodes=8, cluster_size=0), "cluster_size"),
    (dict(n_nodes=8, redundancy=2), "must be odd"),
    (dict(n_nodes=8, cluster_size=4, redundancy=5), "redundancy=5 > "
                                                    "cluster_size=4"),
    (dict(n_nodes=8, schedule="star"), "unknown schedule"),
    (dict(n_nodes=24, cluster_size=4, schedule="butterfly"),
     "power-of-two"),
    (dict(n_nodes=8, transport="carrier-pigeon"), "unknown transport"),
    (dict(n_nodes=8, transport="digest", digest_words=0),
     "digest_words >= 1"),
    (dict(n_nodes=8, transport="digest", digest_words=-3),
     "digest_words >= 1"),
    (dict(n_nodes=8, masking="xor"), "unknown masking"),
    (dict(n_nodes=8, clip=0.0), "clip"),
    (dict(n_nodes=8, guard_bits=-1), "guard_bits"),
    (dict(n_nodes=8, chunk_elems=0), "chunk_elems"),
    (dict(n_nodes=8, kernel_impl="pallas"), "kernel_impl"),
])
def test_invalid_knobs_raise_config_error(kw, needle):
    with pytest.raises(TP.ConfigError) as exc:
        TP.AggConfig(**kw)
    assert needle in str(exc.value)
    assert isinstance(exc.value, ValueError)
    if "kernel_impl" not in kw:      # the reference refuses the same knobs
        with pytest.raises(JP.ConfigError):
            JP.AggConfig(**kw)


def test_runtime_negatives_replace_and_derive():
    # the distributed backends, as in the reference: 'mesh' without a
    # mesh raises; 'auto' resolves to 'mesh' exactly when one is given
    for mod in (TP, JP):
        with pytest.raises(mod.ConfigError, match="needs a mesh"):
            mod.Runtime(backend="mesh")
        assert mod.Runtime(backend="manual").resolve() == "manual"
        assert mod.Runtime().resolve() == "sim"
        assert mod.Runtime(mesh=object()).resolve() == "mesh"
    assert TP.Runtime(dp_axes=["pod", "data"]).dp_axes == ("pod", "data")
    with pytest.raises(TP.ConfigError, match="unknown backend"):
        TP.Runtime(backend="tpu")
    cfg = TP.AggConfig(n_nodes=16, cluster_size=4, redundancy=3)
    with pytest.raises(TP.ConfigError):
        cfg.replace(redundancy=4)
    mixed = cfg.replace(security=TP.Security(redundancy=1), clip=9.0)
    assert (mixed.redundancy, mixed.clip) == (1, 9.0)
    byz = cfg.replace(byzantine=dataclasses.replace(
        cfg.byzantine, corrupt_ranks=(1, 9)))
    jcfg = JP.AggConfig(n_nodes=16, cluster_size=4, redundancy=3,
                        byzantine=JB.ByzantineSpec(corrupt_ranks=(1, 9)))
    for n in (6, 2, 4):
        a, b = byz.derive(n_nodes=n), jcfg.derive(n_nodes=n)
        assert (a.cluster_size, a.redundancy, a.byzantine.corrupt_ranks) \
            == (b.cluster_size, b.redundancy, b.byzantine.corrupt_ranks)


def test_plan_cache_memoises():
    cfg = TP.AggConfig(n_nodes=8, cluster_size=4, guard_bits=5)
    before = TP.plan_cache_stats()
    p1, p2 = TP.compile_plan(cfg), TP.compile_plan(cfg)
    after = TP.plan_cache_stats()
    assert p1 is p2
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"] + 1
