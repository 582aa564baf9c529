"""``python3 -m lesbench --workload NAME --seed N --seconds S --trace 0|1``:
one run of one cell (see ``harness``)."""
import time

T_START = time.perf_counter()

import sys  # noqa: E402

from lesbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
