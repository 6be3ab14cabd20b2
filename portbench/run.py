"""The benchmark of the PyTorch and CUDA port (``hyperopt_tpu_torch``).

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the first visible CUDA device and
prints one JSON line as the last line of standard output (``harness.py``).
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds; no library may bring JAX in.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
    ROOT, "build", "portbench", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "portbench",
                                              "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[0] = ROOT

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
