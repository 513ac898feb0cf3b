"""workload (models/transformer.py): the median wall time of rank 0's steps with no
save or restore in flight, in ms."""

import statistics


def read(rec):
    clean = [s for s, kind in rec["steps"] if kind == "step"]
    return 1e3 * statistics.median(clean) if clean else None
