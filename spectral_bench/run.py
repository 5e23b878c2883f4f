#!/usr/bin/env python3
"""Run one cell of the benchmark of gpuspectral_tpu_torch once.

    python3 spectral_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for.  The last line of standard output is the result (JSON); the compared
numbers and their limits are the last lines of standard error.  See
spectral_bench/README.md.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from spectral_bench.harness.runner import main

    sys.exit(main())
