"""device: the share of the traced window in which no kernel, copy or set ran on the
card, in percent, mean over ranks."""

from harness.record import mean, traces


def read(rec):
    t = traces(rec)
    return mean(100.0 * (1 - x["busy_s"] / x["window_s"]) for x in t) if t else None
