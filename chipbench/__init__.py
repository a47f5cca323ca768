"""The port's benchmark: one command runs one cell once.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Cells, configurations, traffic mixes and per-layer metrics are data: the
root ``BENCHMARK.json`` names them, ``workloads/<cell>.json`` holds a
cell's driver, traffic parameters and correctness limits,
``configs/<config>.json`` its deployment, ``drivers/<kind>.py`` runs a
kind of traffic and ``metrics/<metric>.py`` reads one per-layer metric
from the traced window.  Nothing here imports jax, jaxlib or the JAX
package; ``reference/`` imports nothing of the port either.
"""
