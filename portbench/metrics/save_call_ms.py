"""training loop (manager.py): mean seconds of the window's async_save calls, in ms.
The benchmark's span from the call to its return."""

from harness.record import mean


def read(rec):
    if rec["mode"] != "async" or not rec["saves"]:
        return None
    return 1e3 * mean(s["call_s"] for s in rec["saves"])
