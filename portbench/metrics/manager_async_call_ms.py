"""training loop (manager.py): the program's own span around
CheckpointManager.async_save (registry manager_call_seconds{op="async_save"}, from
the call's entry to its return), ms per call, slowest rank."""

from harness.record import hist_counts, hist_sums


def read(rec):
    if rec["mode"] != "async" or not rec["saves"]:
        return None
    per_rank = [s / n for s, n in zip(hist_sums(rec, "manager_call_seconds", op="async_save"),
                                      hist_counts(rec, "manager_call_seconds", op="async_save")) if n]
    return 1e3 * max(per_rank) if per_rank else None
