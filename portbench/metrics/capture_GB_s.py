"""async capture (io_preparer.py capture): the card memory an async save's device
clones hold, bytes x seconds from the capture until the drain drops each clone
(registry async_capture_device_byte_seconds_total), in GB x s per async save,
slowest rank."""

from harness.record import counters


def read(rec):
    if rec["mode"] != "async" or not rec["saves"]:
        return None
    worst = max(counters(rec, "async_capture_device_byte_seconds_total"))
    return worst / 1e9 / len(rec["saves"]) if worst > 0 else None
