"""device copies (io_preparer.py DeviceCopier): device_to_host_bytes_total over the
profiler's device time of device-to-host copies in the window, GB/s."""

from harness.record import counters, ratio, traces


def read(rec):
    t = traces(rec)
    if not t or not rec["saves"]:
        return None
    r = ratio(sum(counters(rec, "device_to_host_bytes_total")), sum(x["d2h_s"] for x in t))
    return r / 1e9 if r else None
