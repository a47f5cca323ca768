"""``repro_torch.launch.serve_agg --transport mesh`` on the CPU: one gloo
rank process a protocol slot (8 at ``--overlay-n 64``), each with its own
copy of the service, held against the JAX package's ``run_load`` /
``run_func_load`` on the same deployment on its sim (batch sizes, wire
bytes, every session exact).  A rank that raises makes the launcher exit
non-zero at once, not after gloo's timeout.  Each spawn takes a few
seconds; the file keeps them to three."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro import api as J
from repro.core.overlay import build_overlay as j_build_overlay
from repro.launch import serve_agg as JL
from repro.service import BatchingConfig as JBatchingConfig
from repro.service import EpochManager as JEpochManager
from repro_torch.api import ConfigError
from repro_torch.launch import serve_agg

MESH = ["--overlay-n", "64", "--device", "cpu", "--max-age", "1e9",
        "--transport", "mesh", "--batch", "4"]
SPAWN_TIMEOUT_S = 240


def _reference(run, **kw):
    """The reference's load function on the launcher's deployment."""
    em = JEpochManager(j_build_overlay(64, 0.2, seed=42), cluster_size=4)
    snap = em.current()
    agg = J.SecureAggregator(
        topology=J.Topology(n_nodes=snap.n_nodes, cluster_size=4),
        security=J.Security(redundancy=3), epochs=em,
        batching=JBatchingConfig(max_batch=4, max_age=1e9))
    return run(agg, em, churn_every=0, **kw)


@pytest.mark.parametrize("load", ["additive", "median"])
def test_serve_agg_mesh_equals_reference(load, capfd):
    if load == "additive":
        argv = ["--sessions", "12", "--elems", "100"]
        want = _reference(JL.run_load, sessions=12, elems=100)
    else:
        argv = ["--sessions", "8", "--fn", "median", "--steps", "64"]
        want = _reference(JL.run_func_load, sessions=8, fn="median",
                          bins=16, steps=64, k=4)
    out = serve_agg.main(MESH + argv)
    n = want["sessions"]
    assert out["revealed"] == out["exact"] == n
    assert (want["revealed"], want["exact"]) == (n, n)
    assert out["stats"]["batches"]["sizes"] \
        == want["stats"]["batches"]["sizes"]
    assert out["stats"]["wire"] == want["stats"]["wire"]
    text = capfd.readouterr().out
    # rank 0 alone prints the summary, after the parent's mesh line
    assert text.count(f"exact results: {n}/{n}") == 1
    assert "mesh: {'data': 1, 'model': 1} on cpu" in text
    assert "transport=mesh" in text


def test_a_failed_rank_fails_the_launcher_at_once(tmp_path):
    """Rank 0 alone opens the trace sink; with its directory missing it
    raises while the other ranks wait in their first collective.  The
    launcher ends them and exits non-zero long before gloo's 300 s."""
    env = dict(os.environ, PYTHONPATH="src")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_agg", *MESH,
         "--sessions", "8", "--trace-out", str(tmp_path / "no" / "t.jsonl")],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode != 0
    assert "FileNotFoundError" in proc.stderr
    assert "exact results" not in proc.stdout
    assert time.monotonic() - t0 < 120


def test_mesh_launcher_refuses_before_spawning(monkeypatch):
    """No card: the default device raises before any rank starts, and
    nothing falls back to the sim; a host mesh past one rank is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_agg.main(["--transport", "mesh", "--overlay-n", "64"])
    with pytest.raises(ConfigError, match="sharded serve"):
        serve_agg.main(MESH + ["--data", "2"])
