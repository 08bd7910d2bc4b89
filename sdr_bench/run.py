"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 sdr_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the run's notes and the numbers compared on standard error, and
one JSON line of results last on standard output. Exits 2 without a
result where the machine has fewer CUDA devices than the cell asks for.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "sdr_bench", sub)
sys.path.insert(0, ROOT)

from sdr_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
