"""``python3 -m joinbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell (see ``joinbench/run.py``)."""

import time

T0 = time.perf_counter()  # set-up is timed from here, before any import

if __name__ == "__main__":
    import sys

    from joinbench.run import main

    sys.exit(main(t0=T0))
