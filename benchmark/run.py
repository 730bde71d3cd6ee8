"""Run one cell of the benchmark once, on the CUDA card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It measures the PyTorch and CUDA package
``cpuperformanceraytracer_tpu_torch`` on the cell ``BENCHMARK.json``
names, checks what the measured calls produced against the plain
reference in ``benchmark/reference/``, and prints one JSON line last.
Without a card it exits non-zero before printing any result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the build and kernel caches stay inside the checkout, at fixed paths
CACHE = ROOT / "build" / "benchmark" / "cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path[0] = str(ROOT)

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
