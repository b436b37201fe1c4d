"""Run one cell of the benchmark once.

    python3 tallybench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the result as the last line of standard output (``harness.py``) and
the compared numbers beside their limits as the last lines of standard
error. Exits with another code than 0, printing no result, where there is no
CUDA card, the cell asks for more cards than there are, the program is
missing, or JAX or the JAX package was loaded.
"""
import os
import sys
import time


def _process_start() -> float:
    """``time.perf_counter()`` at this process's start, from /proc (the
    time of this line where /proc cannot be read)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return now - max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed paths inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".tallybench_cache", sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from tallybench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
