"""The mesh half of the adversarial conformance grid, on the port.

The reference's ``_MESH_GRID`` (``tests/test_conformance.py``, pinned by
``test_mesh_cells_bit_identical_to_sim_16dev``) at its own size: n = 16,
c = 4, r = 3, T = 64, ring, one session per strategy of
``tests/adversary.py``.  One spawn of 16 rank processes over gloo runs
``MeshTransport`` for every wire transport x masking; every rank's result
must equal JAX's ``run_sim_batch`` bit for bit, its wire account the
sim's, and the faulted batch the honest one.
"""
import dataclasses

import numpy as np
import pytest

import torch_mesh_workers as W
from adversary import ADVERSARIES, run_sim_batch, session_faults
from repro.core.plan import AggConfig, fault_masks_of

RANKS, N, C, R, T = 16, 16, 4, 3, 64
S = len(ADVERSARIES)
CELLS = [(t, m) for t in ("full", "digest")
         for m in ("global", "pairwise", "none")]


def _cfg(transport, masking) -> AggConfig:
    return AggConfig(n_nodes=N, cluster_size=C, redundancy=R,
                     schedule="ring", transport=transport, masking=masking,
                     clip=2.0)


def _inputs():
    rng = np.random.default_rng(13)
    xs = (rng.normal(size=(S, N, T)) * 0.2).astype(np.float32)
    return xs, np.arange(S, dtype=np.uint32) + 3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    xs, seeds = _inputs()
    inputs = {"xs": xs, "seeds": seeds}
    for mode, m in fault_masks_of(session_faults(N, C, R), N).items():
        inputs[f"masks:{mode}"] = m
    cases = [dict(kind="execute", name=f"{t}-{m}", xs="xs", seeds="seeds",
                  masks="masks", cfg=dataclasses.asdict(_cfg(t, m)),
                  mesh=((N,), ("data",)), dp_axes=("data",))
             for t, m in CELLS]
    return W.run_job(str(tmp_path_factory.mktemp("grid")), cases, inputs,
                     RANKS, timeout_s=300)


@pytest.mark.parametrize("transport,masking", CELLS)
def test_mesh_cell_bit_identical_to_reference_sim(run, transport, masking):
    xs, seeds = _inputs()
    cfg = _cfg(transport, masking)
    faults = session_faults(N, C, R)
    want, sim_bytes = run_sim_batch(cfg, xs, seeds=seeds, faults=faults)
    want_ro, _ = run_sim_batch(cfg, xs, seeds=seeds, faults=faults,
                               reveal_only=True)
    honest, _ = run_sim_batch(cfg, xs, seeds=seeds)
    assert np.array_equal(want, honest)       # every adversary absorbed
    assert np.abs(want[:, 0] - xs.sum(1)).max() < 1e-3
    name = f"{transport}-{masking}"
    for rank, out in enumerate(run):
        assert np.array_equal(out[f"{name}/out"], want), rank
        assert np.array_equal(out[f"{name}/reveal"], want_ro), rank
        assert int(out[f"{name}/bytes"]) == sim_bytes, rank
