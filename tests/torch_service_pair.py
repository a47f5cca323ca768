"""Build the reference's and the port's session services from one
description, for the port's service / resilience / obs tests.

The description is the reference's own objects (``SessionParams``,
``BatchingConfig``, ``StreamConfig``, ``RetryPolicy``, ``ChaosConfig``,
``SessionFaultPlan``, an overlay): the port's side is built from their
fields by ``repro_torch.convert``.  Stateful pieces (a circuit breaker, a
trace recorder) are made fresh on each side from the same arguments.
The port runs on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro import obs as JO
from repro import service as JS
from repro.runtime import resilience as JR
from repro_torch import convert as C
from repro_torch import obs as PO
from repro_torch import service as PS
from repro_torch.runtime import resilience as PR


def port_params(params):
    return C.session_params_from_fields(dataclasses.asdict(params))


def _port_kw(kw: dict) -> dict:
    out = dict(kw)
    conv = {"batching": C.batching_from_fields,
            "stream": C.stream_from_fields, "retry": C.retry_from_fields,
            "chaos": C.chaos_from_fields}
    for name, fn in conv.items():
        if out.get(name) is not None:
            out[name] = fn(dataclasses.asdict(out[name]))
    return out


def services(params, *, breaker=None, recorder=None, epochs=None,
             **kw) -> tuple:
    """(reference service, port service) over ``params`` and the same
    knobs.  ``breaker``: CircuitBreaker kwargs; ``recorder``:
    TraceRecorder kwargs other than the clock (each side gets its own
    ``TickClock``), ``sink`` a pair of paths; ``epochs``: a pair of
    EpochManager kwargs dicts (the overlays already carried across)."""
    jkw, pkw = dict(kw), _port_kw(kw)
    if breaker is not None:
        jkw["breaker"] = JR.CircuitBreaker(**breaker)
        pkw["breaker"] = PR.CircuitBreaker(**breaker)
    if recorder is not None:
        rj, rp = dict(recorder), dict(recorder)
        if "sink" in recorder:
            rj["sink"], rp["sink"] = recorder["sink"]
        jkw["recorder"] = JO.TraceRecorder(clock=JO.TickClock(), **rj)
        pkw["recorder"] = PO.TraceRecorder(clock=PO.TickClock(), **rp)
    if epochs is not None:
        jkw["epochs"] = JS.EpochManager(**epochs[0])
        pkw["epochs"] = PS.EpochManager(**epochs[1])
    return (JS.AggregationService(params, **jkw),
            PS.AggregationService(port_params(params), device="cpu", **pkw))


def feed(svc, vals, *, now=0.0, params=None, skip=(), fault=None) -> list:
    """Open and seal one session per ``vals[i]`` ((n, elems) payloads);
    slots in ``skip`` ((i, slot) pairs) never contribute; ``fault`` maps
    a session index to a reference ``SessionFaultPlan``."""
    out = []
    for i in range(len(vals)):
        s = svc.open(params=params, now=now)
        for slot in range(vals.shape[1]):
            if (i, slot) not in skip:
                s.contribute(slot, vals[i, slot])
        if fault and i in fault:
            s.inject_fault(fault_for(svc, fault[i]))
        svc.seal(s.sid, now=now)
        out.append(s)
    return out


def fault_for(svc, plan):
    """A reference ``SessionFaultPlan`` on ``svc``'s side."""
    if isinstance(svc, PS.AggregationService):
        return C.fault_plan_from_fields(dataclasses.asdict(plan))
    return plan


def results(sessions) -> np.ndarray:
    return np.stack([np.asarray(s.result) for s in sessions])


def states(sessions) -> list:
    return [s.state.value for s in sessions]
