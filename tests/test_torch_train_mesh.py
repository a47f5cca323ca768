"""The port's data-parallel training across gloo ranks, on the CPU.

Each case runs in a fresh interpreter (the test process has imported
JAX; the ranks must not) that spawns the ranks through
``repro_torch.launch.train.run_ranks`` (``runtime.compat.spawn_nodes``)
and prints rank 0's result as JSON on its last line.

* The reference's ``tests/test_distributed.py:34`` case on 4 ranks:
  olmo-1b smoke in float32, the secure sync with 2 clusters of 2 and
  r = 1, 8 steps, in the same spawn as the plain all-reduce baseline.
  The secure losses track the port's single-process baseline and the
  reference's one-device baseline (computed here) within 5e-3, the
  4-rank baseline equals the single-process one to float32 rounding.
* ``launch.byzantine_training`` at 8 ranks: clusters of 4, r = 3,
  corrupt ranks (1, 5) in ``mode="garbage"``: the secure losses within
  5e-3 of the baseline, the r = 1 control off it, the vote launched.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_host_mesh as j_mesh
from repro.launch.train import train_loop as j_train
from repro.models import model as JM
from repro.optim import adamw as JA
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch.train import train_loop
from repro_torch.optim import adamw

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50, grad_clip=1.0)


def run_sub(code: str, timeout: int = 300) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-6000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


FOUR_RANKS = """
import dataclasses, json, numpy as np
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import model_params_from_numpy
from repro_torch.core.plan import AggConfig
from repro_torch.launch.train import run_ranks
from repro_torch.optim import adamw
cfg = dataclasses.replace(get_smoke_config('olmo-1b'), dtype='float32')
params = model_params_from_numpy(cfg, np.load(%r, allow_pickle=True).item())
agg = AggConfig(n_nodes=4, cluster_size=2, redundancy=1, clip=8.0)
base, sec = run_ranks(4, [{}, {'secure': True, 'agg': agg}], cfg=cfg,
                      steps=8, shape=ShapeConfig('t', 64, 4, 'train'),
                      opt_cfg=adamw.OptConfig(**%r), log_every=99,
                      device='cpu', params=params, timeout_s=240)
print(json.dumps({'base': base, 'sec': sec}))
"""


def test_secure_training_matches_baseline_4_ranks(tmp_path):
    """From the reference's initial weights (carried across), so the
    reference's one-device losses are comparable."""
    jcfg = dataclasses.replace(j_smoke("olmo-1b"), dtype="float32")
    jparams = jax.tree.map(np.asarray,
                           JM.init_params(jcfg, jax.random.PRNGKey(0)))
    path = str(tmp_path / "params.npy")
    np.save(path, np.array(jparams, dtype=object), allow_pickle=True)
    out = run_sub(FOUR_RANKS % (path, OPT))
    base, sec = out["base"]["losses"], out["sec"]["losses"]
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32")
    single = train_loop(cfg, steps=8, shape=ShapeConfig("t", 64, 4, "train"),
                        opt_cfg=adamw.OptConfig(**OPT), log_every=99,
                        device="cpu", params=model_params_from_numpy(
                            cfg, jparams))["losses"]
    ref = j_train(jcfg, j_mesh(), steps=8, shape=JShape("t", 64, 4, "train"),
                  opt_cfg=JA.OptConfig(**OPT), log_every=99)["losses"]
    np.testing.assert_allclose(base, single, rtol=1e-4)
    np.testing.assert_allclose(sec, single, atol=5e-3)
    np.testing.assert_allclose(sec, ref, atol=5e-3)
    # the secure run went through the sync's kernels' plain versions
    assert out["sec"]["launches"]["mask_encrypt"] == 0


BYZANTINE = """
import json
from repro_torch.launch.byzantine_training import run
print(json.dumps(run(ranks=8, steps=8, device='cpu')))
"""


def test_byzantine_training_8_ranks():
    out = run_sub(BYZANTINE)
    assert out["corrupt"] == [1, 5] and out["redundancy"] == 3
    assert out["max_dev_secure"] < 5e-3
    assert out["max_dev_control_r1"] > 1e-2
    assert len(out["secure"]["losses"]) == 8
