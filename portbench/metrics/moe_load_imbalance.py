"""sparse feed-forward (models/lfm2.py sparse_ffn, the router and dispatch): per
step and sparse layer the most-loaded held expert's tokens times the experts held,
summed (registry moe_held_max_tokens_scaled_total), over the held assignments
(moe_assignments_total{held="1"}): the most-loaded expert's load over the mean
held expert's, 1 where routing is perfectly even."""

from harness.record import counters, ratio


def read(rec):
    scaled = sum(counters(rec, "moe_held_max_tokens_scaled_total"))
    held = sum(counters(rec, "moe_assignments_total", held="1"))
    return ratio(scaled, held)
