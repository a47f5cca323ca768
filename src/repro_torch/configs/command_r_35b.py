"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, no biases, tied embeddings.  [hf:CohereForAI/c4ai-command-r]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense",
        d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22528, vocab_size=256000,
        pattern=(LayerSpec("attn", "dense"),), n_units=40,
        norm="layernorm", tie_embeddings=True,
        rope_theta=4_000_000.0, embedding_multiplier=1.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-smoke", family="dense",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=128,
        pattern=(LayerSpec("attn", "dense"),), n_units=2,
        norm="layernorm", tie_embeddings=True, remat=False,
    )


register("command-r-35b", full, smoke)
