#!/usr/bin/env python3
"""Run one cell as ``run.py --trace 1`` does, with the device's idle gaps
labelled by the program's own spans as well as by the benchmark's.

    python3 portbench/trace_spans.py --workload <cell> --seed <n> --seconds <s> [--out <file.json>]

from the root of a checkout. Every rank profiles its window with
``harness.program_spans.LabelledProfile``, so the result line's
``breakdown.idle_gaps`` read ``<benchmark span>/<program span>``. ``--out``
gets, for each rank, ``idle_by_span`` (idle seconds by label over every
gap, the top 10), ``labelled_s`` (for each benchmark span, the idle
seconds a program span labels and all its idle seconds),
``program_spans`` and ``program_spans_dropped`` (recorder spans the
window's ring evicted); standard error repeats them.
``run.py`` itself is unchanged by this.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run as bench_run  # noqa: E402
from harness import cell as harness_cell  # noqa: E402
from harness.program_spans import install  # noqa: E402

KEYS = ("idle_by_span", "labelled_s", "program_spans", "program_spans_dropped")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", help="write each rank's labelled idle time here (JSON)")
    args, rest = p.parse_known_args()
    if "--trace" not in rest:
        rest += ["--trace", "1"]
    results = []
    run_cell = harness_cell.run_cell

    def labelled_run_cell(*a, **kw):
        out = run_cell(*a, init=install, **kw)
        results.extend(out[2])
        return out

    harness_cell.run_cell = labelled_run_cell
    sys.argv = [os.path.join(HERE, "run.py"), *rest]
    rc = bench_run.main()
    ranks = [{k: (r.trace or {}).get(k) for k in KEYS} for r in results]
    for rank, r in enumerate(ranks):
        print(f"portbench: rank {rank} labelled idle time: {json.dumps(r)}", file=sys.stderr)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"argv": rest, "rc": rc, "ranks": ranks}, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
