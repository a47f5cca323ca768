"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk-norm, tied embeddings.  [hf:Qwen/Qwen3-1.7B]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense",
        d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=6144, vocab_size=151936,
        pattern=(LayerSpec("attn", "dense"),), n_units=28,
        qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0, dp_mode="replicated",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b-smoke", family="dense",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128,
        pattern=(LayerSpec("attn", "dense"),), n_units=2,
        qk_norm=True, tie_embeddings=True, remat=False,
    )


register("qwen3-1.7b", full, smoke)
