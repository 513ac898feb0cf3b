"""sparse feed-forward (models/lfm2.py sparse_ffn, the router and dispatch): the
top-k assignments that landed on the experts this rank holds, over all of them
(registry moe_assignments_total{held="1"} over held="1" and held="0", summed over
steps and sparse layers), in percent, over all ranks; 25 where routing is even
over 8 of 32 experts."""

from harness.record import counters, ratio


def read(rec):
    held = sum(counters(rec, "moe_assignments_total", held="1"))
    absent = sum(counters(rec, "moe_assignments_total", held="0"))
    share = ratio(held, held + absent)
    return 100.0 * share if share is not None else None
