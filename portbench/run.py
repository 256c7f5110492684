"""
Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``warpdrive_tpu_torch``.  The last
line of standard output is the result's JSON object; the numbers compared
for ``correct`` are the last lines of standard error.  Exits with another
code than 0, and prints no result, where there is no card, or where JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The bytecode of every module the run imports, torch's and the port's
# too, goes to a fixed folder of the checkout, whatever the environment
# says (PYTHONDONTWRITEBYTECODE, an installation shipped without
# __pycache__): only a checkout's first run compiles Python sources.
sys.pycache_prefix = str(ROOT / "portbench" / "_cache" / "pycache")
sys.dont_write_bytecode = False
sys.path.insert(0, str(ROOT))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
