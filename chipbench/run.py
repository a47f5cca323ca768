"""Run one cell of the port's benchmark once and print its result line.

    python3 chipbench/run.py --workload secagg-n64.allreduce-full \\
        --seed 7 --seconds 30 --trace 0

Exits non-zero, with no result line, where the card the cell asks for is
missing, the program is missing, or the process has loaded jax.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program inside the checkout, at a
# fixed path, so that only a checkout's first run builds
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from chipbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
