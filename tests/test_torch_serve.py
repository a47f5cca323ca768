"""The port's serving entry point against the JAX package's.

``repro_torch.launch.serve.serve`` on CPU tensors (the kernel wrappers run
their plain versions) must give exactly the greedy tokens of
``repro.launch.serve.serve`` for both archs of the slice in float32: the
prompts are the same (the port's ``SyntheticStream`` is a copy) and so
are the weights (the reference's ``init_params(cfg, PRNGKey(0))``,
carried across by ``repro_torch.convert``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import serve as j_serve
from repro.models import model as JM
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.launch import serve as P

B, PL, G = 2, 16, 8


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m"])
def test_greedy_tokens_equal_the_reference(arch):
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    want = j_serve(jcfg, make_host_mesh(), batch=B, prompt_len=PL, gen=G,
                   seed=0)
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    params = model_params_from_numpy(pcfg, jax.tree.map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0))))
    got = P.serve(pcfg, batch=B, prompt_len=PL, gen=G, seed=0,
                  params=params, device="cpu")
    assert got["tokens"].shape == (B, G)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["tok_per_s"] > 0 and got["t_prefill_s"] > 0


def test_device_none_means_the_card(monkeypatch):
    """Nothing quietly runs on the CPU: without a card ``device=None``
    raises, and an unknown kernel engine is refused."""
    from repro_torch.configs import get_smoke_config as p_smoke
    cfg = p_smoke("qwen3-1.7b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.serve(cfg, batch=1, prompt_len=4, gen=2)
    with pytest.raises(ValueError, match="not in"):
        P.serve(cfg, batch=1, prompt_len=4, gen=2, device="cpu",
                kernel_impl="pallas")


def test_kernel_engine_torch_gives_the_same_tokens():
    """``kernel_impl="torch"`` (the plain versions anywhere) and the
    default (the plain versions on a CPU tensor) agree, in bfloat16 too."""
    from repro_torch.configs import get_smoke_config as p_smoke
    for arch in ("qwen3-1.7b", "mamba2-370m"):
        cfg = p_smoke(arch)
        a = P.serve(cfg, batch=2, prompt_len=12, gen=4, device="cpu")
        b = P.serve(cfg, batch=2, prompt_len=12, gen=4, device="cpu",
                    kernel_impl="torch")
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_cli_runs_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "mamba2-370m",
                                     "--smoke", "--device", "cpu",
                                     "--prompt-len", "8", "--gen", "3",
                                     "--batch", "2"])
    P.main()
    out = capsys.readouterr().out
    assert "tok/s" in out and "sample tokens" in out
