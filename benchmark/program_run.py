"""A traced run of a cell that also writes the program's spans out.

    python3 benchmark/program_run.py --workload <cell> --seed <n> \
        --seconds <s> [--trace-out PATH]

runs the cell as ``run.py --trace 1`` does (the program's tracer on from
before the ``System``, anchored to the traced stretch's profiler; the
line's per-layer metrics, ``breakdown`` and ``program`` entry; the
set-up's span totals and ``idle by program span`` on standard error),
and with ``--trace-out`` writes the spans to a Chrome trace-event file.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run as bench  # noqa: E402  (sets the run's env)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace-out", default=None,
                    help="write the program's spans here (Chrome JSON)")
    args, rest = ap.parse_known_args(argv)
    rc = bench.main(rest + ["--trace", "1"])
    if rc == 0 and args.trace_out:
        from active_orb_slam2_tpu_torch.utils import trace
        trace.write_chrome(args.trace_out)
    return rc


if __name__ == "__main__":
    sys.exit(main())
