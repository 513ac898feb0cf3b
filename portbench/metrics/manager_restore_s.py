"""training loop (manager.py): the program's own span around
CheckpointManager.restore_latest (registry manager_call_seconds{op="restore"}: the
index read, the step's broadcast and the restore, to the call's return), seconds
per restore, slowest rank."""

from harness.record import hist_counts, hist_sums


def read(rec):
    if not rec["restores"]:
        return None
    per_rank = [s / n for s, n in zip(hist_sums(rec, "manager_call_seconds", op="restore"),
                                      hist_counts(rec, "manager_call_seconds", op="restore")) if n]
    return max(per_rank) if per_rank else None
