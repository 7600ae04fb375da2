"""The benchmark's entry point.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is the
result (one JSON object); the numbers that decided ``correct`` are the
last lines of standard error. Exits non-zero with no result when there is
no CUDA card, too few cards for the cell, a file of the cell is missing,
or the JAX package was loaded.
"""

import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
# every build and kernel cache at a fixed path inside the checkout, so
# only the first run of a cell there builds (the port's nvcc libraries go
# to build/torch_kernels by themselves)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(BUILD, sub)
# libraries that would load JAX by themselves stay off it
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
