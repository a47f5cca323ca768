"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
expert d_ff=8192, vocab=202048, MoE 128 experts top-1 + shared expert,
MoE every other layer, chunked-local attention (8192) with a full-attention
layer every 4th (iRoPE-style).  [hf:meta-llama/Llama-4-...]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig, register

# unit of 4 layers: 3 chunked + 1 full; MoE on odd positions (every other)
_PATTERN = (
    LayerSpec("attn_chunked", "dense"),
    LayerSpec("attn_chunked", "moe"),
    LayerSpec("attn_chunked", "dense"),
    LayerSpec("attn", "moe"),
)


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        pattern=_PATTERN, n_units=12,
        attn_window=8192, rope_theta=500_000.0,
        moe=MoEConfig(n_experts=128, top_k=1, d_expert=8192,
                      capacity_factor=1.25, d_shared=8192),
        opt_state_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke", family="moe",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128,
        pattern=_PATTERN, n_units=1,
        attn_window=32,
        moe=MoEConfig(n_experts=4, top_k=1, d_expert=64, d_shared=64),
        remat=False,
    )


register("llama4-maverick-400b-a17b", full, smoke)
