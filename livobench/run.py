"""The benchmark's command: one cell, one seed, one run, one JSON line.

    python3 livobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See livobench/README.md and livobench/harness.py.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# The checkout's root, not this folder, is where modules are found: the
# harness's modules are `livobench.*` and shadow nothing.
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, ROOT)]
os.environ.setdefault("USE_FLAX", "0")
# The host's share of the run, held steady: a fixed set of cores and
# single-threaded host math (the port's host work is many small calls,
# which thread pools only add jitter to).
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

from livobench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
