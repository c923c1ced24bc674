"""Run one cell of the benchmark and print its result as the last line.

    python3 prfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the program under test is ``src/repro_torch``
there, and its kernels build into ``build/repro_torch`` there on the first run.
"""
import time

T0 = time.perf_counter()          # set-up is counted from here

import sys                        # noqa: E402
from pathlib import Path          # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)           # the package, not this directory: its modules are not top-level
sys.path.insert(1, str(ROOT / "src"))

from prfbench import harness      # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
