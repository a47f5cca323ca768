"""``repro_torch.launch.serve_lm`` on the CPU against the reference's
``examples/serve_lm.py``: the same three archs (qwen3-1.7b, mamba2-370m,
jamba-v0.1-52b) at their float32 smoke configs, batch 4, prompts of 32,
16 tokens.  From the reference's weights (``init_params(cfg,
PRNGKey(0))``, as its ``serve`` draws them, carried across) the greedy
tokens equal the reference's ``serve`` (jamba at its own capacity
factor of 1.25, where the MoE drops pairs in the prefill); from the
port's own seeded draw the CLI runs and prints a line an arch."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import serve as j_serve
from repro.models import model as JM
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.launch import serve_lm


def test_serve_lm_matches_reference(capsys):
    params, want = {}, {}
    for arch in serve_lm.ARCHS:
        jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
        pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
        params[arch] = model_params_from_numpy(pcfg, jax.tree.map(
            np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0))))
        want[arch] = j_serve(jcfg, make_host_mesh(), batch=serve_lm.BATCH,
                             prompt_len=serve_lm.PROMPT_LEN,
                             gen=serve_lm.GEN)["tokens"]
    got = serve_lm.main(device="cpu", params=params)
    assert list(got) == list(serve_lm.ARCHS)
    for arch, out in got.items():
        assert out["tokens"].shape == (serve_lm.BATCH, serve_lm.GEN)
        np.testing.assert_array_equal(out["tokens"], np.asarray(want[arch]),
                                      err_msg=arch)
        assert out["tok_per_s"] > 0
        assert sum(out["launches"]["prefill"].values()) == 0
    printed = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in printed] == list(serve_lm.ARCHS)


def test_cli_runs_on_the_cpu(capsys):
    out = serve_lm.cli(["--device", "cpu"])
    for arch in serve_lm.ARCHS:
        toks = out[arch]["tokens"]
        cfg = j_smoke(arch)
        assert toks.shape == (serve_lm.BATCH, serve_lm.GEN)
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert "tok/s" in capsys.readouterr().out


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main()
