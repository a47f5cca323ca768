"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only (bidirectional, no decode shapes).  The convolutional audio
frontend is a STUB: ``input_specs()`` provides precomputed frame embeddings
(B, S, d_model) per the assignment.  [arXiv:2106.07447]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
        d_ff=5120, vocab_size=504,
        pattern=(LayerSpec("attn", "dense"),), n_units=48,
        causal=False, decoder=False,
        norm="layernorm", mlp_gated=False, attn_bias=True,
        frontend="audio_frames", dp_mode="replicated",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", family="audio",
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=96,
        pattern=(LayerSpec("attn", "dense"),), n_units=2,
        causal=False, decoder=False,
        norm="layernorm", mlp_gated=False, attn_bias=True,
        frontend="audio_frames", remat=False,
    )


register("hubert-xlarge", full, smoke)
