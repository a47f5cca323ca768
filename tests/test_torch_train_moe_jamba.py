"""Training of jamba-v0.1-52b (4 experts top-2 beside Mamba2 layers in
its smoke config) against the JAX package, on one rank on the CPU: the
checks of ``tests/test_torch_train_moe.py`` (``loss_fn`` gradients
against ``jax.value_and_grad``, ``train_loop`` losses plain and secure),
at capacity factors 16 and 1.25.
"""
import pytest

from test_torch_train_moe import (FACTORS, check_moe_loss_and_grads,
                                  check_moe_train_loop)

ARCH = "jamba-v0.1-52b"


@pytest.mark.parametrize("cf", FACTORS)
def test_loss_and_grads_match_reference(cf, monkeypatch):
    check_moe_loss_and_grads(ARCH, cf, monkeypatch)


@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("cf", FACTORS)
def test_train_loop_losses_match_reference(cf, secure):
    check_moe_train_loop(ARCH, cf, secure)
