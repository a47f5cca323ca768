"""MoE training with the experts split over ``"data"``, on 2 gloo ranks
on the CPU, against the JAX package on a 2-device host mesh.

qwen3-moe's smoke config in float32 (8 experts top-2, capacity 1.25),
the reference's seed-0 weights carried across (``convert``), AdamW's
moments in float32, 2 steps on the synthetic stream's global batches.
The reference runs its ``build_train_step`` (GSPMD) and
``build_secure_train_step`` (the ``shard_map`` over ``"data"``, its
``_dp_leaf_axes`` leaving the expert stacks out of the sync) in a
subprocess with ``--xla_force_host_platform_device_count=2``, as
``tests/test_distributed.py`` runs its meshes; the port runs the same
steps in one spawn of 2 rank processes (``tests/torch_mesh_workers.py``,
kind ``train_moe``), each rank holding its 4 experts, its tokens
reaching them through ``all_to_all`` and its gradients coming back
through it.  Cases: a global batch of 4 (2 sequences a rank:
``moe_distributed``) and of 2 (1 a rank, fewer than the dp ranks, so
the secure step takes ``moe_distributed_replicated``, whose
``all_reduce_sum`` backward the reference decides; the baseline, as the
reference's GSPMD step, tests the global batch and stays distributed),
each plain and secure, and ``train_loop`` from the full tree (which cuts
each rank's slice itself) at the batch of 4.  Losses, grad norms and
every parameter leaf after 2 steps (a rank's expert slice against the
reference's same rows) within 1e-5 relative (parameters: 1e-5 of each
leaf's largest |entry|).
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.models import model as JM
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.core.engine import tree_flatten
from repro_torch.launch import steps as PS

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_workers as W  # noqa: E402

RANKS = 2
ARCH = "qwen3-moe-235b-a22b"
S, STEPS = 16, 2
# AdamW's eps at 1e-3, not 1e-8: an update lr m / (sqrt(v) + eps) with a
# tiny eps is lr times the sign of a gradient entry near zero (an expert
# that few tokens reach), so float32 noise in such an entry would move a
# parameter by up to 2 lr; with eps near the entries' scale the update is
# smooth in the gradient, and the parameters test the gradients
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=5, total_steps=100,
           grad_clip=1.0)
TOL = 1e-5
CASES = [(False, 4), (True, 4), (False, 2), (True, 2)]
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

REFERENCE = """
import dataclasses, json, pickle, sys
import jax, numpy as np
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.core.plan import AggConfig
from repro.data.pipeline import DataConfig, SyntheticStream
from repro.launch import steps as ST
from repro.launch.mesh import make_host_mesh
from repro.models import model as M
from repro.optim import adamw

arch, S, steps, opt, cases, out = json.loads(sys.argv[1])
cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                          dp_mode="replicated")
mesh = make_host_mesh(data=2, model=1)
opt = adamw.OptConfig(**opt)
res = {}
for secure, gb in cases:
    shape = ShapeConfig("t", S, gb, "train")
    if secure:
        agg = AggConfig(n_nodes=4, clip=8.0).derive(n_nodes=2)
        step, (p_sh, o_sh, b_sh), opt_cfg = ST.build_secure_train_step(
            cfg, mesh, agg, opt_cfg=opt, shape=shape, donate=False)
    else:
        step, (p_sh, o_sh, b_sh), opt_cfg = ST.build_train_step(
            cfg, mesh, opt_cfg=opt, shape=shape, donate=False)
    params = jax.device_put(M.init_params(cfg, jax.random.PRNGKey(0)), p_sh)
    state = jax.device_put(adamw.init_opt_state(opt_cfg, params), o_sh)
    stream = SyntheticStream(DataConfig(seq_len=S, global_batch=gb, seed=0),
                             cfg)
    losses, norms = [], []
    for t in range(steps):
        batch = jax.device_put(stream.global_batch(t), b_sh)
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    res[(bool(secure), gb)] = (losses, norms,
                               jax.tree.map(np.asarray, params))
with open(out, "wb") as f:
    pickle.dump(res, f)
print("REFERENCE DONE")
"""


def _name(secure: bool, gb: int, loop: bool = False) -> str:
    return f"{'secure' if secure else 'plain'}_b{gb}{'_loop' if loop else ''}"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_moe")
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                               dp_mode="replicated")
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    leaves = tree_flatten(model_params_from_numpy(pcfg, jp, "cpu"))[0]
    inputs = {f"p/{i}": t.numpy() for i, t in enumerate(leaves)}
    common = dict(kind="train_moe", cfg=dataclasses.asdict(pcfg),
                  opt=OPT, seq_len=S, steps=STEPS, params="p",
                  mesh=((RANKS,), ("data",)), dp_axes=("data",))
    cases = [dict(common, name=_name(sec, gb), secure=sec, global_batch=gb,
                  loop=False) for sec, gb in CASES]
    cases += [dict(common, name=_name(sec, 4, True), secure=sec,
                   global_batch=4, loop=True) for sec in (False, True)]
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    out = str(tmp / "reference.pkl")
    arg = json.dumps([ARCH, S, STEPS, OPT, CASES, out])
    # the reference's subprocess and the port's ranks run side by side
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, arg], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        outs = W.run_job(str(tmp), cases, inputs, RANKS, timeout_s=240)
        stdout, stderr = ref.communicate(timeout=240)
    finally:
        ref.kill()
    assert ref.returncode == 0, stdout[-4000:] + stderr[-4000:]
    with open(out, "rb") as f:
        want = pickle.load(f)
    return pcfg, outs, want


def _check(pcfg, outs, name, want, with_norms: bool) -> None:
    losses, norms, jparams = want
    full = model_params_from_numpy(pcfg, jparams, "cpu")
    experts = PS.expert_leaves(pcfg, full)
    leaves = tree_flatten(full)[0]
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{name}/losses"], losses, rtol=TOL)
        if with_norms:
            np.testing.assert_allclose(out[f"{name}/grad_norms"], norms,
                                       rtol=TOL)
        for i, (w, ex) in enumerate(zip(leaves, experts)):
            w = w.numpy()
            if ex:
                e_loc = w.shape[0] // RANKS
                w = w[r * e_loc:(r + 1) * e_loc]
            got = out[f"{name}/p{i}"]
            assert got.shape == w.shape, (name, i)
            np.testing.assert_allclose(got, w, rtol=0,
                                       atol=TOL * float(np.abs(w).max()),
                                       err_msg=f"{name} rank {r} leaf {i}")


@pytest.mark.parametrize("secure,gb", CASES,
                         ids=[_name(s, g) for s, g in CASES])
def test_ep_steps_match_reference(run, secure, gb):
    pcfg, outs, want = run
    name = _name(secure, gb)
    _check(pcfg, outs, name, want[(secure, gb)], with_norms=True)
    # 2 sequences a rank take the all_to_all path; 1 a rank, in the
    # secure (manual) step, the replicated one
    replicated = secure and gb < RANKS * 2
    for out in outs:
        assert int(out[f"{name}/calls_moe_distributed_replicated"] > 0) \
            == replicated
        assert int(out[f"{name}/calls_moe_distributed"] > 0) \
            == (not replicated)


@pytest.mark.parametrize("secure", [False, True],
                         ids=["plain", "secure"])
def test_train_loop_cuts_the_expert_slices(run, secure):
    pcfg, outs, want = run
    _check(pcfg, outs, _name(secure, 4, True), want[(secure, 4)],
           with_norms=False)
