"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are ``portbench/workloads/<cell>.json`` and the
configuration it names; ``BENCHMARK.json`` lists the cells and the
metrics each reports.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
check compared with its limit); the same numbers close standard error.
``--trace 1`` reads the per-layer metrics from a profiled window of at
most 10 s (``harness.TRACE_SECONDS``), those timed by the host's clock
from an untraced window of that length before it, and reports no
end-to-end metric; a trace that lost the whole sentinel (``trace.py``)
gives no result.
Without a CUDA device, with fewer than the cell asks for, or without the
program beside the benchmark, the run prints no result and exits with a
code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from portbench.harness import run

    return run(args.workload, args.seed, args.seconds, bool(args.trace), root=root,
               t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
