"""``repro_torch.launch.quickstart`` on the CPU against the reference's
``examples/quickstart.py`` parts: the facade demo's error, voted rounds,
bytes a node and cache counters against the JAX facade's on the same
vectors (the ring arithmetic is exact, so equal); the secure training
run's losses against the reference's ``train_loop`` from the same
weights (the reference's draw carried across), within
``tests/test_train_e2e.py``'s 2e-3 (the smoke config computes in
bfloat16, whose roundings XLA and torch place alike but not always
identically); the serve's tokens in the vocabulary.  Six steps instead of
the quickstart's sixty keep it short; the loss still falls."""
import dataclasses

import jax
import numpy as np

from repro import api as J
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_host_mesh as j_mesh
from repro.launch.train import train_loop as j_train
from repro.models import model as JM
from repro.optim import adamw as JA
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.launch import quickstart

STEPS = 6
LOSS_ATOL = 2e-3


def test_quickstart_matches_reference(capsys):
    jcfg = j_smoke("olmo-1b")
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = model_params_from_numpy(pcfg, jax.tree.map(np.asarray, jp))
    got = quickstart.main(device="cpu", steps=STEPS, params=params)

    agg = J.SecureAggregator(topology=J.Topology(n_nodes=16, cluster_size=4))
    xs = np.random.default_rng(0).normal(size=(16, 512)).astype(np.float32)
    xs *= 0.05
    err = float(np.abs(np.asarray(agg.allreduce(xs))[0] - xs.sum(0)).max())
    k = agg.cost(512)
    assert got["facade"] == {"err": err, "rounds": k["rounds"],
                             "bytes_per_node": k["bytes_per_node"],
                             "fn_cache": agg.stats()["fn_cache"]}

    s = quickstart.SHAPE
    o = quickstart.OPT
    want = j_train(jcfg, j_mesh(), steps=STEPS,
                   shape=JShape(s.name, s.seq_len, s.global_batch, s.kind),
                   secure=True, log_every=1000,
                   opt_cfg=JA.OptConfig(lr=o.lr, warmup_steps=o.warmup_steps,
                                        total_steps=o.total_steps))
    np.testing.assert_allclose(got["train"]["losses"], want["losses"],
                               atol=LOSS_ATOL, rtol=0)
    assert got["train"]["losses"][-1] < got["train"]["losses"][0]

    toks = got["serve"]["tokens"]
    assert toks.shape == (2, 8)
    assert ((toks >= 0) & (toks < jcfg.vocab_size)).all()
    out = capsys.readouterr().out
    assert "secure allreduce of (16, 512)" in out and "generated:" in out
