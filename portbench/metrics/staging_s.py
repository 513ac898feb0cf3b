"""pipeline (scheduler.py): seconds from a save's start to the end of its staging
phase (registry snapshot_phase_seconds{phase="staging"}), per save, slowest rank."""

from harness.record import hist_counts, hist_sums


def read(rec):
    per_rank = [s / n for s, n in zip(hist_sums(rec, "snapshot_phase_seconds", phase="staging"),
                                      hist_counts(rec, "snapshot_phase_seconds", phase="staging")) if n]
    return max(per_rank) if rec["saves"] and per_rank else None
