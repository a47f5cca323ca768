"""mamba2-370m [ssm] — 48L d_model=1024, attention-free, d_ff=0 (no MLP),
vocab=50280, ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=0, vocab_size=50280,
        pattern=(LayerSpec("mamba2", "none"),), n_units=48,
        tie_embeddings=True, dp_mode="replicated",
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke", family="ssm",
        d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=128,
        pattern=(LayerSpec("mamba2", "none"),), n_units=2,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=16, chunk=32),
        remat=False,
    )


register("mamba2-370m", full, smoke)
