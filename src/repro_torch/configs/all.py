"""Import every ported architecture config to populate the registry.

The port carries five of the reference's ten configs so far: the dense
models (qwen3-1.7b, command-r-35b with its LayerNorm, qwen1.5-110b with
its QKV biases and untied head, olmo-1b with its non-parametric
LayerNorm, which the reference's training tests and examples use) and
mamba2-370m.  The other five wait for their slices: MoE
(qwen3-moe-235b, llama4-maverick, jamba-v0.1-52b), then cross-attention
and the frontends (llama-3.2-vision-90b, hubert-xlarge); ``ROADMAP.md``
Queue 1.
"""
from repro_torch.configs import (command_r_35b, mamba2_370m, olmo_1b,
                                 qwen3_1p7b, qwen15_110b)

__all__ = ["qwen3_1p7b", "mamba2_370m", "olmo_1b", "command_r_35b",
           "qwen15_110b"]
