"""storage (storage_plugins/fs.py, _native.py): storage_write_bytes_total over the
summed storage_write_seconds of the window's writes, GB/s (a stream's rate)."""

from harness.record import counters, hist_sums, ratio


def read(rec):
    r = ratio(sum(counters(rec, "storage_write_bytes_total")), sum(hist_sums(rec, "storage_write_seconds")))
    return r / 1e9 if r and rec["saves"] else None
