"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1 interleave.

Jamba block = 8 layers: attention at position 3, the rest Mamba; MoE MLP on
odd positions (every other layer), dense MLP on even.  The Mamba mixer here
is the SSD (mamba2-style) formulation — adaptation noted in DESIGN §6.
[arXiv:2403.19887]"""
from repro_torch.configs.base import (LayerSpec, ModelConfig, MoEConfig,
                                      SSMConfig, register)

_PATTERN = tuple(
    LayerSpec("attn" if i == 3 else "mamba2", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=65536,
        pattern=_PATTERN, n_units=4,
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=256),
        opt_state_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128,
        pattern=_PATTERN, n_units=1,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=128),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
        remat=False,
    )


register("jamba-v0.1-52b", full, smoke)
