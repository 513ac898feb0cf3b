"""training loop (manager.py): the window's restore_latest time over the number of
restores, each from the call to a torch.cuda.synchronize() after it returns, in seconds."""

from harness.record import mean


def read(rec):
    return mean(r["s"] for r in rec["restores"]) if rec["restores"] else None
