"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit); the last lines of standard error repeat the
checks.  Without enough CUDA devices, or with a JAX module loaded, it exits
non-zero and prints no result.
"""

import sys
import time

T0 = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark.harness import env  # noqa: E402

env.cache_bytecode(ROOT)
env.prepare(ROOT)

from benchmark.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
