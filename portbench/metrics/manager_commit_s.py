"""training loop (manager.py): rank 0's commit of a saved step (registry
manager_phase_seconds{phase="commit"}: the index read, retention, the index write,
the step deletes and the chunk GC), seconds per save of the window."""

from harness.record import hist_sums


def read(rec):
    if not rec["saves"]:
        return None
    total = hist_sums(rec, "manager_phase_seconds", phase="commit")[0]
    return total / len(rec["saves"]) if total > 0 else None
