"""workload beside the drain: the mean wall time of rank 0's steps that ran between
an async_save call and its commit, in ms."""

from harness.record import mean


def read(rec):
    drain = [s for s, kind in rec["steps"] if kind == "drain"]
    return 1e3 * mean(drain) if drain else None
