"""Run one cell of the port's benchmark once and print its result line.

    python3 witbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result, one JSON object; the
numbers compared with the plain reference, each with its limit, are the
last lines of standard error.  Without a CUDA card (or with fewer than the
cell asks for) it exits 2 and prints no result.  `--rehearse` runs the
cell on the CPU at a handful of lanes on the port's plain versions, makes
every comparison, and exits 3 with no result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root in place of this script's directory, whose module
# names (trace, ...) would shadow the standard library's
sys.path[0] = str(Path(__file__).resolve().parents[1])

from witbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
