"""Import every ported architecture config to populate the registry.

The port carries eight of the reference's ten configs: the dense models
(qwen3-1.7b, command-r-35b with its LayerNorm, qwen1.5-110b with its QKV
biases and untied head, olmo-1b with its non-parametric LayerNorm, which
the reference's training tests and examples use), mamba2-370m, and the
MoE models (qwen3-moe-235b-a22b, llama4-maverick-400b-a17b with its
shared expert and chunked attention, jamba-v0.1-52b with its Mamba2 and
attention layers).  The other two wait for the cross-attention and
frontends slice (llama-3.2-vision-90b, hubert-xlarge); ``ROADMAP.md``
Queue 1.
"""
from repro_torch.configs import (command_r_35b, jamba_v01_52b,
                                 llama4_maverick, mamba2_370m, olmo_1b,
                                 qwen3_1p7b, qwen3_moe_235b, qwen15_110b)

__all__ = ["qwen3_1p7b", "mamba2_370m", "olmo_1b", "command_r_35b",
           "qwen15_110b", "qwen3_moe_235b", "llama4_maverick",
           "jamba_v01_52b"]
