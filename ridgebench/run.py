"""Run one cell of the port's benchmark once and print its result line.

    python3 ridgebench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Exits 2 without a result where no CUDA card
(or fewer than the cell asks for) is there.  ``harness.py`` says what a
run does.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT / "src")
sys.path.insert(1, str(ROOT))

from ridgebench import harness  # noqa: E402

if __name__ == "__main__":
    harness.cache_dirs()
    sys.exit(harness.main(sys.argv[1:], T_START))
