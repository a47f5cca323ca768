"""Seeded generators of the benchmark's inputs: the same seed gives the
same inputs, made on the device in a few large calls."""

SEED_MASK = (1 << 63) - 1


def generator(seed: int, salt: int, device):
    """A torch generator on ``device`` for stream ``salt`` of ``seed``."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) & SEED_MASK)
    return g
