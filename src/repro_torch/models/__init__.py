"""The port's model stack (qwen3-1.7b and mamba2-370m so far)."""
