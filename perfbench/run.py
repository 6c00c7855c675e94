"""The benchmark of the port on one card: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` also
``breakdown``), and the numbers of the comparison with the reference last
on standard error. Exits with another code than 0, and prints no result,
without a CUDA card. Keeps the CUDA kernel cache inside the checkout.
"""
import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, ".perfbench_cache", "nv")
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from perfbench import harness

    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
