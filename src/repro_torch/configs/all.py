"""Import every ported architecture config to populate the registry.

The port carries three of the reference's ten configs so far: the two
that serve through the port's kernels, and olmo-1b (its non-parametric
LayerNorm), which the reference's training tests and examples use.  The
other seven wait for their slices (MoE, cross-attention and frontends;
``ROADMAP.md`` Queue 1 item 10).
"""
from repro_torch.configs import mamba2_370m, olmo_1b, qwen3_1p7b

__all__ = ["qwen3_1p7b", "mamba2_370m", "olmo_1b"]
