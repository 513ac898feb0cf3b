"""training loop (manager.py): rank 0's post-commit hooks of a save (registry
manager_phase_seconds{phase="bookkeeping"}: step history, run ledger, SLO
evaluation, CDN publish, autotune), seconds per save of the window."""

from harness.record import hist_sums


def read(rec):
    if not rec["saves"]:
        return None
    total = hist_sums(rec, "manager_phase_seconds", phase="bookkeeping")[0]
    return total / len(rec["saves"]) if total > 0 else None
