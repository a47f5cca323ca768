"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) moe d_ff=1536
vocab=151936, MoE 128 experts top-8, qk-norm.  [hf:Qwen/Qwen3-...]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab_size=151936,
        pattern=(LayerSpec("attn", "moe"),), n_units=94,
        qk_norm=True, rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536,
                      capacity_factor=1.25),
        opt_state_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=128,
        pattern=(LayerSpec("attn", "moe"),), n_units=2,
        qk_norm=True,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=96),
        remat=False,
    )


register("qwen3-moe-235b-a22b", full, smoke)
