"""training loop (manager.py): the window's blocking CheckpointManager.save time over
the number of saves, each save the slowest rank's call, in seconds."""

from harness.record import mean


def read(rec):
    if rec["mode"] != "sync" or not rec["saves"]:
        return None
    return mean(s["call_s"] for s in rec["saves"])
