"""The benchmark's command, run from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run of one cell of BENCHMARK.json on the card; its last line on
standard output is the result's JSON object (see portbench/README.md).
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root (for `portbench`) and src/ (for the program), in
# place of this script's own folder
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
