"""checkpoint threads (scheduler.py, snapshot.py, storage_plugins/fs.py): the CPU
seconds (time.thread_time) the checkpoint's own threads burned beside training,
registry checkpoint_thread_cpu_seconds_total over every role (snapshot-commit,
ts-stage, ts-consume, storage), per async save, slowest rank. Not a GIL reading."""

from harness.record import counters


def read(rec):
    if rec["mode"] != "async" or not rec["saves"]:
        return None
    worst = max(counters(rec, "checkpoint_thread_cpu_seconds_total"))
    return worst / len(rec["saves"]) if worst > 0 else None
