"""The port's engine on the single-device oracle against the JAX
package's, over the adversary grid of ``tests/adversary.py``: the seven
strategies run as seven sessions of one batch, for every wire transport
and masking mode.  Results and executed wire bytes must be equal, and a
chunked run must equal the monolithic one."""
import dataclasses

import numpy as np
import pytest
import torch

from adversary import session_faults, run_sim_batch
from repro.core.plan import AggConfig as JAggConfig
from repro_torch.convert import config_from_fields
from repro_torch.core.byzantine import ByzantineSpec
from repro_torch.core.engine import (SimTransport, execute_chunks,
                                     pack_chunks, sim_batch, unpack_chunks)
from repro_torch.core.plan import SessionMeta, compile_plan
from repro_torch.core.schedules import schedule_cost

N, C, R, T = 16, 4, 3, 96
WIRES = {"full": dict(transport="full"),
         "digest": dict(transport="digest"),
         "digest-nobackup": dict(transport="digest", digest_backup=False)}


def _grid_inputs():
    rng = np.random.default_rng(17)
    faults = session_faults(N, C, R)
    S = len(faults)
    xs = (rng.normal(size=(S, N, T)) * 0.3).astype(np.float32)
    seeds = rng.integers(0, 2 ** 32, size=S, dtype=np.uint32)
    offsets = np.zeros(S, np.uint32)
    offsets[1] = 2 ** 32 - 50          # the counter wraps inside the row
    return xs, seeds, offsets, faults


def _port_faults(faults):
    return [[ByzantineSpec(corrupt_ranks=tuple(sp.corrupt_ranks),
                           mode=sp.mode) for sp in specs]
            for specs in faults]


@pytest.mark.parametrize("reveal_only", [False, True])
@pytest.mark.parametrize("masking", ["global", "pairwise", "none"])
@pytest.mark.parametrize("wire", sorted(WIRES))
def test_sim_batch_matches_reference_over_adversary_grid(wire, masking,
                                                         reveal_only):
    xs, seeds, offsets, faults = _grid_inputs()
    jcfg = JAggConfig(n_nodes=N, cluster_size=C, redundancy=R,
                      masking=masking, clip=2.0, **WIRES[wire])
    want, want_bytes = run_sim_batch(jcfg, xs, seeds=seeds, offsets=offsets,
                                     faults=faults, reveal_only=reveal_only)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    S = xs.shape[0]
    meta = SessionMeta.build(S, N, device="cpu", seeds=seeds,
                             offsets=offsets, faults=_port_faults(faults))
    got, tp = sim_batch(compile_plan(cfg), torch.from_numpy(xs), meta,
                        reveal_only=reveal_only)
    assert np.array_equal(got.numpy(), want)
    assert tp.bytes_sent == want_bytes
    assert want_bytes == S * schedule_cost(
        "ring", N // C, C, R, 4 * T, digest=cfg.transport == "digest",
        digest_bytes=4 * cfg.digest_words,
        digest_backup=cfg.digest_backup)["bytes_total"]


@pytest.mark.parametrize("masking", ["global", "pairwise"])
@pytest.mark.parametrize("wire", ["full", "digest"])
def test_chunked_run_equals_monolithic(wire, masking):
    """Chunk k covers pad positions [k*Tc, (k+1)*Tc), so K chunks through
    the double-buffered hop pipeline reproduce the one-chunk run; the
    digest transport ships one digest set per chunk."""
    xs, seeds, offsets, faults = _grid_inputs()
    cfg = config_from_fields(dataclasses.asdict(JAggConfig(
        n_nodes=N, cluster_size=C, redundancy=R, masking=masking, clip=2.0,
        **WIRES[wire])))
    plan = compile_plan(cfg)
    S = xs.shape[0]
    meta = SessionMeta.build(S, N, device="cpu", seeds=seeds,
                             offsets=offsets, faults=_port_faults(faults))
    mono, tp1 = sim_batch(plan, torch.from_numpy(xs), meta)
    K = 3
    flat = torch.from_numpy(xs).reshape(S * N, T)
    tp = SimTransport(plan, S=S, device="cpu")
    outs = execute_chunks(plan, tp, list(flat.chunk(K, dim=1)), meta)
    assert torch.equal(torch.cat(outs, dim=1).reshape(S, N, T), mono)
    assert tp.bytes_sent == plan.wire_bytes(T, S=S, chunks=K)
    assert tp1.bytes_sent == plan.wire_bytes(T, S=S)


def test_pack_unpack_round_trip():
    leaves = [torch.arange(10, dtype=torch.float32).reshape(2, 5),
              torch.zeros((0,)), torch.ones(7)]
    chunks = pack_chunks(leaves, 4)
    assert [c.shape[0] for c in chunks] == [4] * 5
    back = unpack_chunks(chunks, leaves)
    for a, b in zip(back, leaves):
        assert torch.equal(a, b)
