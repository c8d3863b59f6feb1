"""Run one cell of the benchmark once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  Every build and kernel cache stays inside the checkout (the program's
kernels under ``build/``), so only a checkout's first run builds.  Exits
non-zero, with no result, where CUDA or enough cards are missing, where a
shape compiled inside the window, or where JAX or the JAX package was
loaded.
"""

import time

T0 = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, "build", "perfbench", _sub)
# the package is imported from the root, not from this folder
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]
sys.path.insert(0, ROOT)

from perfbench.harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], T0))
