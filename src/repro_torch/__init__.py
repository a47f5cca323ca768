"""PyTorch + CUDA port of the secure-aggregation system.

A second package beside the JAX reference ``repro``: the same protocol
(plan compiler, engine, single-device oracle, facade) in torch, and the
paper's DA protocol with threshold Paillier (``core/protocol.py``,
``crypto/``), with the reference's Pallas kernels replaced by
hand-written CUDA kernels for Hopper (``csrc/``).  It never imports
``jax`` or ``repro``.  Importing it needs no GPU: kernels are built at
their first launch.

    from repro_torch import SecureAggregator, Topology
"""
from repro_torch.api import (AggConfig, ConfigError, Runtime,
                             SecureAggregator, Security, SessionMeta,
                             Topology, Wire)

__all__ = ["AggConfig", "ConfigError", "Runtime", "SecureAggregator",
           "Security", "SessionMeta", "Topology", "Wire"]
