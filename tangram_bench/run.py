"""The benchmark's one command:

    python3 tangram_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with a CUDA card.  Prints
one JSON line (correct, attempted, failed, metrics, device, checks).
"""
import os
import sys
import time

T0 = time.perf_counter()        # set-up is timed from here
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from tangram_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))
