"""Run one cell of the benchmark on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last the compared numbers under
``checks``); the compared numbers beside their limits are also the last
lines of standard error.  See ``benchmark/harness.py``.
"""

import time

T0 = time.perf_counter()   # set-up counts from here, before torch is imported

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# kernel caches at fixed paths inside the checkout, whatever the program
# would pick
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
# one host thread for CPU operators: the pool's idle threads spin beside the
# thread that feeds the card, and moved the decode cell's rate by 15 % from
# run to run on a shared host (NVIDIA H100, 700 W)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
