"""The port's DA protocol, NL baseline, Theorem 1 Monte Carlo and overlay
against the JAX package, exactly.

Both protocols run on one overlay, carried across by
``convert.overlay_from_fields``, each with a fresh ``Adversary`` (its
``random.Random(7)`` is consumed by a run).  At ``key_bits <= 32`` the
threshold key's modulus is fixed, so the output, the expected sum, the
message and byte accounts, g and the cluster sizes are all determined by
the seeds and must be equal.  With ``kernel_crypto=True`` (the port's
default) Step 4 runs on the port's plain torch Montgomery ladder
(``device="cpu"``) and on the reference's Pallas kernel in interpret mode.
"""
import dataclasses

import pytest

from repro.core import baseline_nl as JN
from repro.core import lower_bound as JLB
from repro.core import overlay as JO
from repro.core import protocol as JD
from repro_torch.convert import overlay_fields, overlay_from_fields
from repro_torch.core import baseline_nl as PN
from repro_torch.core import lower_bound as PLB
from repro_torch.core import overlay as PO
from repro_torch.core import protocol as PD

ADVERSARIES = {
    "default": {},
    "drop": dict(drop_rate=0.3, corrupt_ring=True, bad_inputs=True),
    "silent": dict(drop_rate=1.0, corrupt_ring=False),
    "random_inputs": dict(bad_inputs=False, corrupt_ring=True),
}
CASES = [(64, 0.0, 3, "default"), (64, 0.2, 5, "default"),
         (96, 0.3, 1, "drop"), (64, 0.3, 5, "silent"),
         (128, 0.3, 2, "random_inputs")]
# the reference's ladder runs in Pallas interpret mode, so the kernel
# route is compared on all but the largest overlay
KERNEL_CASES = CASES[:4]


def _result_fields(r) -> dict:
    d = dataclasses.asdict(r)
    return {k: d[k] for k in ("output", "expected", "exact", "stats",
                              "phase_bytes", "n", "g", "cluster_sizes")}


@pytest.mark.parametrize("n,tau,seed,adv,kernel_crypto",
                         [c + (False,) for c in CASES]
                         + [c + (True,) for c in KERNEL_CASES])
def test_da_protocol_matches_reference(n, tau, seed, adv, kernel_crypto):
    jov = JO.build_overlay(n, tau, seed=seed)
    pov = overlay_from_fields(overlay_fields(jov))
    want = JD.DAProtocol(jov, seed=seed, kernel_crypto=kernel_crypto,
                         adversary=JD.Adversary(**ADVERSARIES[adv])).run()
    got = PD.DAProtocol(pov, seed=seed, kernel_crypto=kernel_crypto,
                        device="cpu",
                        adversary=PD.Adversary(**ADVERSARIES[adv])).run()
    assert _result_fields(got) == _result_fields(want)
    assert got.exact and got.output is not None
    assert sum(got.phase_bytes.values()) == got.stats.bytes


@pytest.mark.parametrize("kernel_crypto", [True, False])
def test_run_da_matches_reference(kernel_crypto):
    for n, tau, seed in ((64, 0.0, 3), (128, 0.3, 1)):
        got = PD.run_da(n, tau=tau, seed=seed, kernel_crypto=kernel_crypto,
                        device="cpu")
        assert _result_fields(got) == \
            _result_fields(JD.run_da(n, tau=tau, seed=seed))


def test_step4_runs_on_the_card_by_default(monkeypatch):
    """By default Step 4 goes through the kernel on the card, and raises
    without one rather than falling back to the CPU; only
    ``kernel_crypto=False`` asks for per-share ``pow`` on the host."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ov = PO.build_overlay(32, 0.0, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.DAProtocol(ov).run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.run_da(32, tau=0.0)
    assert PD.run_da(32, tau=0.0, kernel_crypto=False).exact


def test_da_protocol_with_given_primes(monkeypatch):
    """``primes=(p, q)`` keys the threshold cluster with those safe primes:
    the run equals the reference's with its keygen given the same primes,
    and every ciphertext is counted at the size of that key's n^2."""
    from repro.crypto import paillier as JP
    P, Q = 16777907, 16778123             # safe primes: n^2 of 13 bytes
    keygen = JP.threshold_keygen
    monkeypatch.setattr(JD, "threshold_keygen",
                        lambda **kw: keygen(**{**kw, "p": P, "q": Q}))
    jov = JO.build_overlay(64, 0.2, seed=5)
    want = JD.DAProtocol(jov, seed=5).run()
    got = PD.DAProtocol(overlay_from_fields(overlay_fields(jov)), seed=5,
                        device="cpu", primes=(P, Q)).run()
    assert _result_fields(got) == _result_fields(want)
    assert got.exact
    sizes = got.cluster_sizes
    setup_msgs = sizes[-1] ** 2 + sum(a * b for a, b in zip(sizes, sizes[1:]))
    ct_bytes = ((P * Q) ** 2).bit_length() + 7 >> 3
    assert ct_bytes == 13
    assert got.phase_bytes["setup"] == setup_msgs * ct_bytes


@pytest.mark.parametrize("n", [16, 32])
def test_run_nl_matches_reference(n):
    got, want = PN.run_nl(n, key_bits=32), JN.run_nl(n, key_bits=32)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.exact and got.output == got.expected
    big = PN.run_nl(512, crypto_cutoff=0)
    assert dataclasses.asdict(big) == dataclasses.asdict(
        JN.run_nl(512, crypto_cutoff=0))


def test_lower_bound_matches_reference():
    for n, eps, w in ((128, 0.25, 2), (256, 0.25, 4), (128, 0.4, 3)):
        assert PLB.surround_probability(n, eps, w, trials=20, seed=3) == \
            JLB.surround_probability(n, eps, w, trials=20, seed=3)
        assert PLB.predicted(n, eps, w) == JLB.predicted(n, eps, w)
    assert PLB.phase_table(trials=4, ns=(128, 256)) == \
        JLB.phase_table(trials=4, ns=(128, 256))


@pytest.mark.parametrize("n,tau,seed", [(64, 0.3, 0), (200, 0.1, 4)])
def test_overlay_matches_reference_and_round_trips(n, tau, seed):
    jov = JO.build_overlay(n, tau, seed=seed)
    pov = PO.build_overlay(n, tau, seed=seed)
    assert overlay_fields(pov) == overlay_fields(jov)
    assert pov.check_invariants() == jov.check_invariants()
    carried = overlay_from_fields(overlay_fields(jov))
    assert overlay_fields(carried) == overlay_fields(jov)
    assert [[dataclasses.asdict(nd) for nd in cl] for cl in carried.clusters()
            ] == [[dataclasses.asdict(nd) for nd in cl]
                  for cl in jov.clusters()]
    # the random state came across too: further churn replays identically
    for ov in (jov, carried):
        ov.join(honest=False)
        ov.leave(3)
        ov.join(honest=True)
    assert overlay_fields(carried) == overlay_fields(jov)
