"""coordination (dist_store.py, pg_wrapper.py): coordination_store_seconds_total plus
coordination_barrier_wait_seconds_total per save, slowest rank."""

from harness.record import counters


def read(rec):
    if rec["ranks"] < 2 or not rec["saves"]:
        return None
    store = counters(rec, "coordination_store_seconds_total")
    barrier = counters(rec, "coordination_barrier_wait_seconds_total")
    return max(a + b for a, b in zip(store, barrier)) / len(rec["saves"])
