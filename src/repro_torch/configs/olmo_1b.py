"""olmo-1b [dense] — 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304,
non-parametric LayerNorm, tied embeddings.  [arXiv:2402.00838]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=8192, vocab_size=50304,
        pattern=(LayerSpec("attn", "dense"),), n_units=16,
        norm="nonparam_ln", tie_embeddings=True, dp_mode="replicated",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke", family="dense",
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128,
        pattern=(LayerSpec("attn", "dense"),), n_units=2,
        norm="nonparam_ln", tie_embeddings=True, remat=False,
    )


register("olmo-1b", full, smoke)
