"""The port's spans and counters where the checkpoint's work happens: the
manager's calls, commit, GC and bookkeeping, the take's and the
restore's plans, the restore's placement and apply, the storage calls'
service time on their worker threads, the checkpoint threads' CPU and
the async capture's device bytes. Each span nests as the code that
emits it, and each moves the registry series a reader works from.

This file imports no ``jax``.
"""

import asyncio
import os
import threading

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, TensorTreeState, telemetry
from torchsnapshot_tpu_torch.io_preparer import count_device_capture
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.telemetry import names
from torchsnapshot_tpu_torch.telemetry.trace import get_recorder

torch.set_num_threads(1)

# Above the inline-staging size, so that staging and consuming run on the
# pipelines' worker threads.
BIG = (1 << 20) // 4 + 1024


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset_metrics()
    telemetry.reset_trace()
    yield
    telemetry.reset_metrics()
    telemetry.reset_trace()


def _state(seed, size=BIG):
    rng = np.random.default_rng(seed)
    return {
        f"l{i}": torch.from_numpy(rng.standard_normal(size).astype(np.float32)) for i in range(2)
    }


def _spans(mark, name):
    return [e for e in get_recorder().events_since(mark) if e["ph"] == "X" and e["name"] == name]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _hist(name, **labels):
    """(count, sum) of the histogram series with these labels."""
    key = telemetry.series_key(name, labels)
    h = telemetry.metrics().collect()["histograms"].get(key)
    return (h["count"], h["sum"]) if h else (0, 0.0)


def _counters(name):
    """label dict -> value of every series of the counter ``name``."""
    out = {}
    for key, value in telemetry.metrics().collect()["counters"].items():
        base, labels = telemetry.parse_series_key(key)
        if base == name:
            out[tuple(sorted(labels.items()))] = value
    return out


def test_save_spans_nest_and_move_their_histograms(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "root"), keep_last_n=1)
    mark = get_recorder().mark()
    for step in (1, 2):
        mgr.save(step, {"m": TensorTreeState(_state(step))})
    saves = _spans(mark, names.SPAN_MANAGER_SAVE)
    takes = _spans(mark, names.SPAN_TAKE)
    plans = _spans(mark, names.SPAN_TAKE_PLAN)
    commits = _spans(mark, names.SPAN_MANAGER_COMMIT)
    gcs = _spans(mark, names.SPAN_MANAGER_GC)
    books = _spans(mark, names.SPAN_MANAGER_BOOKKEEPING)
    assert len(saves) == len(takes) == len(plans) == len(commits) == len(gcs) == len(books) == 2
    for save, take, plan, commit, gc, book in zip(saves, takes, plans, commits, gcs, books):
        assert _inside(take, save) and _inside(plan, take)
        assert _inside(commit, save) and _inside(gc, commit) and _inside(book, save)
        assert take["ts"] + take["dur"] <= commit["ts"] <= book["ts"]
        assert set(book["args"]) >= {"history_s", "ledger_s", "slo_s", "cdn_s", "autotune_s"}
    # The second commit dropped step 1: its own bytes, both leaves.
    assert gcs[0]["args"]["steps"] == 0 and gcs[0]["args"]["bytes"] == 0
    assert gcs[1]["args"]["steps"] == 1 and gcs[1]["args"]["bytes"] >= 2 * BIG * 4
    assert _hist(names.MANAGER_CALL_SECONDS, op="save")[0] == 2
    assert _hist(names.MANAGER_PHASE_SECONDS, phase="commit")[0] == 2
    assert _hist(names.MANAGER_PHASE_SECONDS, phase="bookkeeping")[0] == 2
    count, total = _hist(names.MANAGER_CALL_SECONDS, op="save")
    assert total == pytest.approx(sum(s["dur"] for s in saves) / 1e6, rel=0.05, abs=2e-3)


def test_gc_that_cannot_count_its_bytes_still_drops_the_step(tmp_path, monkeypatch, caplog):
    """Counting a dropped step's bytes comes after its delete, for the GC
    span and the ledger only: a manifest that cannot be counted leaves
    the count at 0 and reports no failed GC."""
    from torchsnapshot_tpu_torch import fsck

    def uncountable(manifest):
        raise ValueError("uncountable")

    root = tmp_path / "root"
    mgr = CheckpointManager(str(root), keep_last_n=1)
    mgr.save(1, {"m": TensorTreeState(_state(1))})
    monkeypatch.setattr(fsck, "blob_requirements", uncountable)
    mark = get_recorder().mark()
    mgr.save(2, {"m": TensorTreeState(_state(2))})
    gc = _spans(mark, names.SPAN_MANAGER_GC)[0]
    assert gc["args"]["steps"] == 1 and gc["args"]["bytes"] == 0
    assert mgr.all_steps() == [2]
    assert "Failed to GC" not in caplog.text and "could not count" in caplog.text


def test_async_save_spans_thread_cpu_and_commit_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "root"))
    mark = get_recorder().mark()
    pending = mgr.async_save(1, {"m": TensorTreeState(_state(1))})
    calls = _spans(mark, names.SPAN_MANAGER_ASYNC_SAVE)
    assert len(calls) == 1 and not _spans(mark, names.SPAN_MANAGER_COMMIT)
    pending.wait()
    (stage,) = _spans(mark, names.SPAN_ASYNC_TAKE_STAGE)
    (plan,) = _spans(mark, names.SPAN_TAKE_PLAN)
    (commit,) = _spans(mark, names.SPAN_MANAGER_COMMIT)
    assert _inside(stage, calls[0]) and _inside(plan, stage)
    assert _inside(_spans(mark, names.SPAN_MANAGER_GC)[0], commit)
    assert len(_spans(mark, names.SPAN_MANAGER_BOOKKEEPING)) == 1
    assert _hist(names.MANAGER_CALL_SECONDS, op="async_save")[0] == 1
    assert _hist(names.MANAGER_PHASE_SECONDS, phase="commit")[0] == 1
    cpu = {dict(k)["role"]: v for k, v in _counters(names.CHECKPOINT_THREAD_CPU_SECONDS_TOTAL).items()}
    assert {"snapshot-commit", "ts-stage", "storage"} <= set(cpu)
    assert all(v >= 0 for v in cpu.values()) and cpu["snapshot-commit"] > 0
    # A second wait commits nothing again.
    pending.wait()
    assert _hist(names.MANAGER_PHASE_SECONDS, phase="commit")[0] == 1


def test_restore_spans_nest_and_move_their_histograms(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "root"))
    src = _state(3)
    mgr.save(1, {"m": TensorTreeState(dict(src))})
    dst = {"m": TensorTreeState({k: torch.zeros_like(v) for k, v in src.items()})}
    mark = get_recorder().mark()
    assert mgr.restore_latest(dst) == 1
    assert all(torch.equal(dst["m"].tree[k], v) for k, v in src.items())
    (call,) = _spans(mark, names.SPAN_MANAGER_RESTORE)
    (restore,) = _spans(mark, names.SPAN_RESTORE)
    (plan,) = _spans(mark, names.SPAN_RESTORE_PLAN)
    (apply,) = _spans(mark, names.SPAN_RESTORE_APPLY)
    places = _spans(mark, names.SPAN_RESTORE_PLACE)
    assert _inside(restore, call)
    assert _inside(plan, restore) and _inside(apply, restore)
    assert places and all(_inside(p, restore) for p in places)
    # The plan ends before the first read, the apply starts after the last.
    reads = _spans(mark, names.SPAN_STORAGE_READ)
    data_reads = [r for r in reads if r["ts"] >= plan["ts"] + plan["dur"]]
    assert data_reads and all(r["ts"] + r["dur"] <= apply["ts"] for r in data_reads)
    assert _hist(names.MANAGER_CALL_SECONDS, op="restore")[0] == 1
    assert _hist(names.RESTORE_PHASE_SECONDS, phase="place")[0] == len(places)
    cpu = {dict(k)["role"] for k in _counters(names.CHECKPOINT_THREAD_CPU_SECONDS_TOTAL)}
    assert {"ts-consume", "storage"} <= cpu
    # restore() is the same call, timed once.
    mgr.restore(1, dst)
    assert _hist(names.MANAGER_CALL_SECONDS, op="restore")[0] == 2


def test_storage_service_is_inside_each_operation(tmp_path, monkeypatch):
    """Each storage call observes its service seconds once, and no more
    than the seconds its event-loop side observes."""
    observed = []
    registry = telemetry.metrics()
    real = registry.histogram_observe

    def spy(name, value, buckets=None, **labels):
        observed.append((name, value))
        return real(name, value, buckets, **labels)

    monkeypatch.setattr(registry, "histogram_observe", spy)
    plugin = FSStoragePlugin(str(tmp_path))
    payload = os.urandom(3 << 20)

    async def ops():
        await plugin.write(WriteIO(path="a", buf=payload))
        await plugin.write_with_checksum(WriteIO(path="b", buf=payload))
        await plugin.read(ReadIO(path="a"))
        await plugin.read(ReadIO(path="b", byte_range=(10, 1 << 20)))
        await plugin.read_with_checksum(ReadIO(path="b"))

    asyncio.run(ops())
    pairs = {
        names.STORAGE_WRITE_SERVICE_SECONDS: names.STORAGE_WRITE_SECONDS,
        names.STORAGE_READ_SERVICE_SECONDS: names.STORAGE_READ_SECONDS,
    }
    relevant = [(n, v) for n, v in observed if n in pairs or n in pairs.values()]
    assert len(relevant) == 10
    for (service, s), (loop_side, l) in zip(relevant[::2], relevant[1::2]):
        assert pairs[service] == loop_side
        assert 0 < s <= l
    cpu = _counters(names.CHECKPOINT_THREAD_CPU_SECONDS_TOTAL)
    assert list(cpu) == [(("role", "storage"),)]


def test_thread_cpu_counts_a_thread_once_and_timed_span_args():
    def work():
        return sum(i * i for i in range(20000))

    assert telemetry.run_counted("ts-stage", telemetry.run_counted, "storage", work) == work()
    cpu = {dict(k)["role"]: v for k, v in _counters(names.CHECKPOINT_THREAD_CPU_SECONDS_TOTAL).items()}
    assert set(cpu) == {"ts-stage"} and cpu["ts-stage"] > 0
    mark = get_recorder().mark()
    with telemetry.timed_span(names.SPAN_RESTORE_APPLY) as args:
        args["leaves"] = 3
    with telemetry.timed_span(names.SPAN_RESTORE_PLACE, names.RESTORE_PHASE_SECONDS, phase="place"):
        pass
    (apply,) = _spans(mark, names.SPAN_RESTORE_APPLY)
    (place,) = _spans(mark, names.SPAN_RESTORE_PLACE)
    assert apply["args"] == {"leaves": 3} and place["args"] == {"phase": "place"}
    assert _hist(names.RESTORE_PHASE_SECONDS, phase="place")[0] == 1


def test_device_capture_counts_bytes_and_byte_seconds():
    snap = torch.ones(1000, dtype=torch.float32)
    count_device_capture(snap)
    assert _counters(names.ASYNC_CAPTURE_DEVICE_BYTES_TOTAL) == {(): 4000.0}
    assert _counters(names.ASYNC_CAPTURE_DEVICE_BYTE_SECONDS_TOTAL) == {}
    del snap
    held = _counters(names.ASYNC_CAPTURE_DEVICE_BYTE_SECONDS_TOTAL)
    assert list(held) == [()] and held[()] >= 0


@pytest.mark.cuda_only
def test_async_save_counts_the_device_clone_until_the_drain_drops_it(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    state = {k: v.cuda() for k, v in _state(5).items()}
    mgr = CheckpointManager(str(tmp_path / "root"))
    mgr.async_save(1, {"m": TensorTreeState(state)}).wait()
    assert _counters(names.ASYNC_CAPTURE_DEVICE_BYTES_TOTAL) == {(): 2.0 * BIG * 4}
    assert _counters(names.ASYNC_CAPTURE_DEVICE_BYTE_SECONDS_TOTAL)[()] > 0


def test_a_thread_that_reuses_an_ident_gets_its_own_track():
    """A pool's worker may start with a finished worker's ident: its spans
    carry its own thread name, which the idle-gap labels read."""
    recorder = get_recorder()
    mark = recorder.mark()
    thread = threading.current_thread()
    name = thread.name
    try:
        for worker in ("asyncio_0", "ts-stage_0"):
            thread.name = worker
            recorder.end(recorder.begin(names.SPAN_LEAF_STAGE))
    finally:
        thread.name = name
    tracks = recorder.tid_names()
    assert [tracks[e["tid"]] for e in _spans(mark, names.SPAN_LEAF_STAGE)] == ["asyncio_0", "ts-stage_0"]
