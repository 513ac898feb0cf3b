"""restore placement (snapshot.py _StreamingPlacer): host_to_device_bytes_total over
the profiler's device time of host-to-device copies in the window, GB/s."""

from harness.record import counters, ratio, traces


def read(rec):
    t = traces(rec)
    if not t or not rec["restores"]:
        return None
    r = ratio(sum(counters(rec, "host_to_device_bytes_total")), sum(x["h2d_s"] for x in t))
    return r / 1e9 if r else None
