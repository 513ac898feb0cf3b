"""storage (storage_plugins/fs.py, _native.py): storage_write_bytes_total over the
summed storage_write_service_seconds of the window's writes, GB/s: each write timed
on its worker thread alone, without the executor queue and the event loop that
storage_write_seconds (write_GBps) include."""

from harness.record import counters, hist_sums, ratio


def read(rec):
    r = ratio(sum(counters(rec, "storage_write_bytes_total")),
              sum(hist_sums(rec, "storage_write_service_seconds")))
    return r / 1e9 if r and rec["saves"] else None
