"""The port's serving entry point against the JAX package's.

``repro_torch.launch.serve.serve`` on CPU tensors (the kernel wrappers run
their plain versions) must give exactly the greedy tokens of
``repro.launch.serve.serve`` for qwen3-1.7b, mamba2-370m and jamba (MoE
at a capacity factor of 16, as the reference's serve test) in float32: the
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


def _cfg16(arch):
    """The smoke config in float32; an MoE config at a capacity factor of
    16, as the reference's ``tests/test_serve.py`` runs it (no pair
    drops, so a decode step routes its token as the full forward does)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    return cfg


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m",
                                  "jamba-v0.1-52b"])
def test_greedy_tokens_equal_the_reference(arch):
    jcfg = _cfg16(arch)
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


def test_jamba_greedy_decode_matches_full_forward():
    """The reference's ``test_greedy_decode_matches_full_forward`` for
    jamba, in the port alone: greedy decode through the KV / SSM caches
    and the MoE's decode-sized dispatch (T = B tokens, capacity 8) gives
    the tokens of greedy decode by a full forward over the grown
    sequence at every step."""
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.models import model as PM
    pcfg = model_config_from_fields(dataclasses.asdict(
        _cfg16("jamba-v0.1-52b")))
    params = PM.init_params(pcfg, torch.Generator().manual_seed(0))
    got = P.serve(pcfg, batch=B, prompt_len=PL, gen=G, seed=0,
                  params=params, device="cpu")["tokens"]
    stream = SyntheticStream(DataConfig(seq_len=PL, global_batch=B, seed=0),
                             pcfg)
    cur = torch.from_numpy(stream.global_batch(0)["tokens"])
    want = []
    for _ in range(G):
        logits = PM.forward(pcfg, params, {"tokens": cur})
        nxt = torch.argmax(logits[:, -1, :pcfg.vocab_size], -1)[:, None]
        want.append(nxt.numpy())
        cur = torch.cat([cur, nxt.to(cur.dtype)], dim=1)
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))


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
