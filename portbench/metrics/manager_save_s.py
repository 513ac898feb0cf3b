"""training loop (manager.py): the program's own span around CheckpointManager.save
(registry manager_call_seconds{op="save"}, from the call's entry to its return),
seconds per save, slowest rank."""

from harness.record import hist_counts, hist_sums


def read(rec):
    if rec["mode"] != "sync" or not rec["saves"]:
        return None
    per_rank = [s / n for s, n in zip(hist_sums(rec, "manager_call_seconds", op="save"),
                                      hist_counts(rec, "manager_call_seconds", op="save")) if n]
    return max(per_rank) if per_rank else None
