"""Entry point: `python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`, run from the root of a checkout."""

import time

T_START = time.perf_counter()  # set-up is counted from here, before torch is imported

if __name__ == "__main__":
    import sys

    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
