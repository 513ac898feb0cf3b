"""Live-progress heartbeats of the port: file atomicity under a concurrent
reader, the lifecycle (removed on success, terminal on failure), the
always-on in-memory ``current_progress`` view mid-take, and the shared
progress dir.

Ports of the JAX package's ``tests/test_progress.py``, case by case (each
docstring names the case it ports), on torch state. This file imports no
``jax``: the cross-package reads are in
``tests/test_torch_telemetry_crosspkg.py``. Every case that waits on a
reader or poller thread joins it with a timeout.
"""

import asyncio
import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, knobs, telemetry
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.telemetry import progress

torch.set_num_threads(1)

_JOIN_TIMEOUT_S = 60.0


def _state(n=8, size=4096, seed=0):
    rng = np.random.default_rng(seed)
    return {f"l{i}": torch.from_numpy(rng.standard_normal(size).astype(np.float32)) for i in range(n)}


def _nbytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in state.values())


def _slow_writes(monkeypatch, delay_s=0.03):
    """Per-blob write latency in the fs plugin, so that a take is slow
    enough for pollers to observe mid-flight; the fused write+checksum
    path declines so that every write takes the patched plain path."""
    orig = FSStoragePlugin.write

    async def slow_write(self, write_io):
        await asyncio.sleep(delay_s)
        await orig(self, write_io)

    async def decline_fused(self, write_io):
        return None

    monkeypatch.setattr(FSStoragePlugin, "write", slow_write)
    monkeypatch.setattr(FSStoragePlugin, "write_with_checksum", decline_fused)


def _run_with(thread_fn, body):
    """Run ``body`` while ``thread_fn(stop)`` polls on a thread; the
    thread is stopped and joined (bounded) whatever ``body`` does."""
    stop = threading.Event()
    t = threading.Thread(target=thread_fn, args=(stop,), daemon=True)
    t.start()
    try:
        body()
    finally:
        stop.set()
        t.join(_JOIN_TIMEOUT_S)
    assert not t.is_alive()


def test_progress_path_resolution(tmp_path):
    """Ports ``test_progress_path_resolution``: interval <= 0 disables the
    file; the dir knob wins over the snapshot-adjacent file; object-store
    paths get no file without it; dir-mode names carry the path digest and
    the kind."""
    assert progress.progress_path_for(str(tmp_path), 0) is None  # conftest 0
    with knobs.override_progress_interval_seconds(0.5):
        assert progress.progress_path_for(str(tmp_path), 1) == str(tmp_path / ".progress-rank1.json")
        assert progress.progress_path_for("s3://bucket/snap", 0) is None
        with knobs.override_progress_dir(str(tmp_path / "out")):
            assert progress.progress_path_for("s3://bucket/snap", 2) == str(
                tmp_path / "out" / "progress-rank2.json"
            )
            a = progress.progress_path_for("s3://bucket/step_1", 0, kind="take")
            b = progress.progress_path_for("s3://bucket/step_2", 0, kind="take")
            c = progress.progress_path_for("s3://bucket/step_1", 0, kind="async_take")
            assert len({a, b, c}) == 3


def test_dir_mode_findings_filter_by_snapshot_path(tmp_path):
    """Ports ``test_dir_mode_findings_filter_by_snapshot_path``: discovery
    for snapshot A never returns snapshot B's heartbeats."""
    out = tmp_path / "out"
    out.mkdir()
    dig_a = progress._path_digest("s3://bucket/a")
    dig_b = progress._path_digest("s3://bucket/b")
    (out / f"progress-{dig_a}-take-rank0.json").write_text(
        json.dumps({"kind": "take", "path": "s3://bucket/a", "terminal": None})
    )
    (out / f"progress-{dig_b}-take-rank0.json").write_text(
        json.dumps({"kind": "take", "path": "s3://bucket/b", "terminal": None})
    )
    with knobs.override_progress_dir(str(out)):
        found = progress.find_progress_files("s3://bucket/a")
    assert [os.path.basename(f) for f in found] == [f"progress-{dig_a}-take-rank0.json"]


def test_concurrent_reader_sees_valid_monotonic_heartbeats(tmp_path, monkeypatch):
    """Ports ``test_concurrent_reader_sees_valid_monotonic_heartbeats``:
    every concurrent read parses, written_bytes never decreases, and the
    file is gone once the take completes."""
    _slow_writes(monkeypatch)
    snap = str(tmp_path / "snap")
    heartbeat = os.path.join(snap, ".progress-rank0.json")
    docs, raw_failures = [], []

    def reader(stop):
        while not stop.is_set():
            try:
                with open(heartbeat, "r", encoding="utf-8") as f:
                    raw = f.read()
            except OSError:
                time.sleep(0.001)
                continue
            try:
                docs.append(json.loads(raw))
            except ValueError:
                raw_failures.append(raw)
            time.sleep(0.001)

    def body():
        with knobs.override_progress_interval_seconds(0.001):
            Snapshot.take(snap, {"s": TensorTreeState(_state())})

    _run_with(reader, body)
    assert not raw_failures, f"torn reads: {raw_failures[:3]}"
    assert docs, "reader never saw a heartbeat"
    written = [d["written_bytes"] for d in docs]
    assert written == sorted(written), "written_bytes regressed"
    assert all(d["kind"] == "take" for d in docs)
    assert all(d["schema_version"] == progress.PROGRESS_SCHEMA_VERSION for d in docs)
    assert not os.path.exists(heartbeat)
    planned = docs[-1]["planned_bytes"]
    assert planned == _nbytes(_state())
    assert written[-1] <= planned


def test_current_progress_mid_take(tmp_path, monkeypatch):
    """Ports ``test_current_progress_mid_take``: with no file knobs, a
    poller thread sees the live take with growing counters, and the op
    unregisters at completion."""
    _slow_writes(monkeypatch)
    snap = str(tmp_path / "snap")
    rows = []

    def poller(stop):
        while not stop.is_set():
            rows.extend(telemetry.current_progress())
            time.sleep(0.002)

    _run_with(poller, lambda: Snapshot.take(snap, {"s": TensorTreeState(_state())}))
    takes = [r for r in rows if r["kind"] == "take"]
    assert takes, "current_progress never showed the live take"
    assert takes[0]["path"] == snap
    assert takes[0]["rank"] == 0
    written = [r["written_bytes"] for r in takes]
    assert written == sorted(written)
    assert any(r["planned_bytes"] == _nbytes(_state()) for r in takes)
    assert any(r["phase"] in ("staging", "writing") for r in takes)
    assert not glob.glob(os.path.join(snap, ".progress*"))
    assert telemetry.current_progress() == []


def test_heartbeat_refreshes_while_write_is_blocked(tmp_path, monkeypatch):
    """Ports ``test_heartbeat_refreshes_while_write_is_blocked``: a write
    blocked for 0.6 s makes no pipeline event, yet the refresher keeps
    rewriting the heartbeat (``updated_unix_ts`` advances with
    ``written_bytes`` frozen)."""
    _slow_writes(monkeypatch, delay_s=0.6)
    snap = str(tmp_path / "snap")
    heartbeat = os.path.join(snap, ".progress-rank0.json")
    stamps = set()

    def reader(stop):
        while not stop.is_set():
            doc = progress.load_progress_file(heartbeat)
            if doc is not None and doc["written_bytes"] == 0:
                stamps.add(doc["updated_unix_ts"])
            time.sleep(0.01)

    def body():
        with knobs.override_progress_interval_seconds(0.05):
            Snapshot.take(snap, {"s": TensorTreeState(_state(n=1, size=256))})

    _run_with(reader, body)
    assert len(stamps) >= 4, stamps


def test_failed_take_leaves_terminal_heartbeat(tmp_path, monkeypatch):
    """Ports ``test_failed_take_leaves_terminal_heartbeat``: a take whose
    writes fail leaves a terminal heartbeat naming the error."""

    async def broken_write(self, write_io):
        raise OSError("injected disk failure")

    monkeypatch.setattr(FSStoragePlugin, "write", broken_write)
    monkeypatch.setattr(FSStoragePlugin, "write_with_checksum", broken_write)
    snap = str(tmp_path / "snap")
    with knobs.override_progress_interval_seconds(0.001):
        with pytest.raises(OSError):
            Snapshot.take(snap, {"s": TensorTreeState(_state(n=2))})
    doc = progress.load_progress_file(os.path.join(snap, ".progress-rank0.json"))
    assert doc["terminal"] == "failed"
    assert "injected disk failure" in doc["error"]
    assert telemetry.current_progress() == []


def test_restore_progress_accumulates_across_pipelines(tmp_path, monkeypatch):
    """Ports ``test_restore_progress_accumulates_across_pipelines``: a
    restore's per-stateful pipelines fold into one tracker whose totals
    end at the full byte count."""
    snap = str(tmp_path / "snap")
    state_a, state_b = _state(n=2, seed=1), _state(n=3, seed=2)
    Snapshot.take(snap, {"a": TensorTreeState(state_a), "b": TensorTreeState(state_b)})
    rows = []
    orig_finish = progress.ProgressTracker.finish

    def spy_finish(self, error=None):
        rows.append(self.snapshot())
        orig_finish(self, error)

    monkeypatch.setattr(progress.ProgressTracker, "finish", spy_finish)
    dest = {
        "a": TensorTreeState({k: torch.zeros_like(v) for k, v in state_a.items()}),
        "b": TensorTreeState({k: torch.zeros_like(v) for k, v in state_b.items()}),
    }
    Snapshot(snap).restore(dest)
    restores = [r for r in rows if r["kind"] == "restore"]
    assert len(restores) == 1
    total = _nbytes(state_a) + _nbytes(state_b)
    assert restores[0]["planned_bytes"] == total
    assert restores[0]["written_bytes"] == total
    assert restores[0]["items_done"] == len(state_a) + len(state_b)


def test_async_take_heartbeat_settles_on_background_thread(tmp_path, monkeypatch):
    """Ports ``test_async_take_heartbeat_settles_on_background_thread``:
    the async take's heartbeat is live through the drain and removed when
    the commit thread settles it."""
    _slow_writes(monkeypatch, delay_s=0.02)
    snap = str(tmp_path / "snap")
    with knobs.override_progress_interval_seconds(0.001):
        pending = Snapshot.async_take(snap, {"s": TensorTreeState(_state(n=4))})
        live = [r for r in telemetry.current_progress() if r["kind"] == "async_take"]
        assert live and live[0]["path"] == snap
        pending.wait()
    assert not os.path.exists(os.path.join(snap, ".progress-rank0.json"))
    assert telemetry.current_progress() == []


def test_manager_gc_reaps_dir_mode_heartbeats(tmp_path):
    """Ports ``test_manager_gc_reaps_dir_mode_heartbeats``: dropping a
    step removes its own dir-mode leftovers and only those."""
    out = tmp_path / "out"
    out.mkdir()
    snap_a = "s3://bucket/step_1"
    dig_a = progress._path_digest(snap_a)
    dig_b = progress._path_digest("s3://bucket/step_2")
    (out / f"progress-{dig_a}-take-rank0.json").write_text("{}")
    (out / f"progress-{dig_b}-take-rank0.json").write_text("{}")
    with knobs.override_progress_dir(str(out)):
        progress.remove_dir_heartbeats(snap_a)
    assert [p.name for p in sorted(out.iterdir())] == [f"progress-{dig_b}-take-rank0.json"]


def test_find_and_load_progress_files(tmp_path):
    """Ports ``test_find_and_load_progress_files``: snapshot-adjacent
    leftovers are found, and an unreadable file loads as None."""
    snap = tmp_path / "snap"
    snap.mkdir()
    good = snap / ".progress-rank0.json"
    good.write_text(json.dumps({"kind": "take", "terminal": None}))
    bad = snap / ".progress-rank1.json"
    bad.write_text("{torn")
    files = progress.find_progress_files(str(snap))
    assert [os.path.basename(f) for f in files] == [".progress-rank0.json", ".progress-rank1.json"]
    assert progress.load_progress_file(str(good))["kind"] == "take"
    assert progress.load_progress_file(str(bad)) is None
