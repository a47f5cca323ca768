"""Deterministic synthetic data (a copy of the reference's pipeline)."""
