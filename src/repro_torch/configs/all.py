"""Import every ported architecture config to populate the registry.

The port carries all ten of the reference's configs: the dense models
(qwen3-1.7b, command-r-35b with its LayerNorm, qwen1.5-110b with its QKV
biases and untied head, olmo-1b with its non-parametric LayerNorm, which
the reference's training tests and examples use), mamba2-370m, the MoE
models (qwen3-moe-235b-a22b, llama4-maverick-400b-a17b with its shared
expert and chunked attention, jamba-v0.1-52b with its Mamba2 and
attention layers), and the two with a modality frontend stub:
llama-3.2-vision-90b (cross-attention to precomputed patch embeddings
every fifth layer) and hubert-xlarge (an encoder over precomputed audio
frames, bidirectional, head dim 80).
"""
from repro_torch.configs import (command_r_35b, hubert_xlarge, jamba_v01_52b,
                                 llama4_maverick, llama32_vision_90b,
                                 mamba2_370m, olmo_1b, qwen3_1p7b,
                                 qwen3_moe_235b, qwen15_110b)

__all__ = ["qwen3_1p7b", "mamba2_370m", "olmo_1b", "command_r_35b",
           "qwen15_110b", "qwen3_moe_235b", "llama4_maverick",
           "jamba_v01_52b", "llama32_vision_90b", "hubert_xlarge"]
