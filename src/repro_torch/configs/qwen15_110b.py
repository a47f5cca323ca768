"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-110B]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=49152, vocab_size=152064,
        pattern=(LayerSpec("attn", "dense"),), n_units=80,
        attn_bias=True, rope_theta=1_000_000.0,
        opt_state_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b-smoke", family="dense",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=128,
        pattern=(LayerSpec("attn", "dense"),), n_units=2,
        attn_bias=True, remat=False,
    )


register("qwen1.5-110b", full, smoke)
