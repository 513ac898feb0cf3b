"""API envelope (snapshot.py): mean PendingSnapshot.committed_s of the window's
async saves, seconds from the call to the commit marker."""

from harness.record import mean


def read(rec):
    committed = [s["committed_s"] for s in rec["saves"] if s.get("committed_s") is not None]
    return mean(committed) if rec["mode"] == "async" and committed else None
