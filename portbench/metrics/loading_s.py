"""pipeline (scheduler.py): seconds from a restore's start to the end of its loading
phase (registry snapshot_phase_seconds{phase="loading"}), per restore, slowest rank."""

from harness.record import hist_counts, hist_sums


def read(rec):
    per_rank = [s / n for s, n in zip(hist_sums(rec, "snapshot_phase_seconds", phase="loading"),
                                      hist_counts(rec, "snapshot_phase_seconds", phase="loading")) if n]
    return max(per_rank) if rec["restores"] and per_rank else None
