"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; cross-attention image layers every 5th layer.

The vision tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (B, n_media_tokens, d_model) consumed by the
cross-attention layers.  [hf:meta-llama/Llama-3.2-90B-Vision]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register

_PATTERN = (
    LayerSpec("attn", "dense"),
    LayerSpec("attn", "dense"),
    LayerSpec("attn", "dense"),
    LayerSpec("attn", "dense"),
    LayerSpec("cross_attn", "dense"),
)


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=28672, vocab_size=128256,
        pattern=_PATTERN, n_units=20,
        rope_theta=500_000.0,
        frontend="vision_patches", n_media_tokens=4096,
        opt_state_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-smoke", family="vlm",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=128,
        pattern=_PATTERN, n_units=1,
        frontend="vision_patches", n_media_tokens=16, remat=False,
    )


register("llama-3.2-vision-90b", full, smoke)
