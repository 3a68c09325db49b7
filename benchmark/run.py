"""Runs one cell of the benchmark of sie_tpu_torch once, from the root of
a checkout:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result (JSON); the comparisons
that decide `correct` are the last lines of standard error. Exits
non-zero, printing no result, without the cards the cell asks for.
"""

import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    from benchmark import harness
    try:
        run = harness.start(sys.argv[1:] if argv is None else argv, T_START)
    except harness.Failure as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    return harness.report(run)


if __name__ == "__main__":
    sys.exit(main())
