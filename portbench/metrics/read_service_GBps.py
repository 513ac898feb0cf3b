"""storage (storage_plugins/fs.py, _native.py): storage_read_bytes_total over the
summed storage_read_service_seconds of the window's reads, GB/s: each read timed on
its worker thread alone, without the executor queue and the event loop that
storage_read_seconds (read_GBps) include."""

from harness.record import counters, hist_sums, ratio


def read(rec):
    r = ratio(sum(counters(rec, "storage_read_bytes_total")),
              sum(hist_sums(rec, "storage_read_service_seconds")))
    return r / 1e9 if r and rec["restores"] else None
