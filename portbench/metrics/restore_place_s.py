"""restore placement (snapshot.py _StreamingPlacer): the host-to-device placement
batches and the final wait for the copy streams (registry
restore_phase_seconds{phase="place"}), seconds per restore, slowest rank."""

from harness.record import hist_sums


def read(rec):
    if not rec["restores"]:
        return None
    worst = max(hist_sums(rec, "restore_phase_seconds", phase="place"))
    return worst / len(rec["restores"]) if worst > 0 else None
