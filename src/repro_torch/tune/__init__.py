"""Self-tuning planner: workload signature -> winning protocol config,
scored with the exact wire-byte oracle.  Counterpart of ``repro/tune``;
see ``tune/planner.py`` for the model."""
from repro_torch.tune.planner import (TuneDecision, Tuner, clear_tuner_cache,
                                      expected_retransmit_bytes,
                                      tuner_cache_stats)
from repro_torch.tune.signature import WorkloadSignature

__all__ = ["TuneDecision", "Tuner", "WorkloadSignature",
           "clear_tuner_cache", "expected_retransmit_bytes",
           "tuner_cache_stats"]
