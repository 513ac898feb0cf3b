"""write partition (partitioner.py): the largest rank's share of the bytes the
window's saves wrote, in percent (100 / ranks is even)."""

from harness.record import counters


def read(rec):
    written = counters(rec, "storage_write_bytes_total")
    if rec["ranks"] < 2 or not rec["saves"] or sum(written) <= 0:
        return None
    return 100.0 * max(written) / sum(written)
