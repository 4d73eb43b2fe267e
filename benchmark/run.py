"""Run one cell of BENCHMARK.json on this machine's card(s):

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the run's result (JSON); the numbers
the check compared, each beside its limit, are the last lines of standard
error. Exits non-zero, printing no result, without the cards the cell asks
for or when the run loaded JAX or the JAX package.
"""

import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root, in place of this script's folder (whose module names
# would shadow the standard library's).
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=_T0))
