"""Async take, async restore and streaming placement of the port.

Ports of the ``pg=None`` cases of the JAX package's
``tests/test_async_take.py``, ``tests/test_async_restore.py`` and
``tests/test_streaming_restore.py``: the visible span ends before staging
and storage I/O, ``wait(phase=)`` orders the staged point before the commit,
a failure leaves no commit marker and re-raises on every wait, a source
mutated in place after ``async_take`` returns restores as it was at the
call; an async restore leaves the live leaves untouched until ``wait()``;
placements stream between read completions. What the port writes is read
back by the JAX package too. Bytes are compared bit for bit.
"""

import asyncio
import os
import time
from unittest import mock

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu_torch import RngState, Snapshot, StateDict, TensorTreeState, knobs
from torchsnapshot_tpu_torch import snapshot as snapshot_mod
from torchsnapshot_tpu_torch.io_preparer import ArrayBufferStager
from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_METADATA_FNAME
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

torch.set_num_threads(1)


def _bytes(t) -> bytes:
    if isinstance(t, np.ndarray):
        return t.tobytes()
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


class SlowFSStoragePlugin(FSStoragePlugin):
    DELAY_S = 0.3

    async def write(self, write_io) -> None:
        if write_io.path != SNAPSHOT_METADATA_FNAME:
            await asyncio.sleep(self.DELAY_S)
        await super().write(write_io)

    async def write_with_checksum(self, write_io):
        await self.write(write_io)  # no fused path: every write is slow


def _faulty_plugin(should_fail, delay_s: float = 0.0):
    class FaultyFSStoragePlugin(FSStoragePlugin):
        async def write(self, write_io) -> None:
            await asyncio.sleep(delay_s)
            if should_fail(write_io.path):
                raise OSError("injected storage failure")
            await super().write(write_io)

        async def write_with_checksum(self, write_io):
            await self.write(write_io)

    return FaultyFSStoragePlugin


def _patch_plugin(cls):
    return mock.patch.object(snapshot_mod, "url_to_storage_plugin", lambda p: cls(root=p))


def _sleepy_stage(delay_s: float):
    orig = ArrayBufferStager._stage_host

    def slow(self, t):
        time.sleep(delay_s)
        return orig(self, t)

    return mock.patch.object(ArrayBufferStager, "_stage_host", slow)


# ---------------------------------------------------------------------------
# async take
# ---------------------------------------------------------------------------


def test_async_take_roundtrip(tmp_path) -> None:
    w = torch.arange(128.0)
    pending = Snapshot.async_take(
        str(tmp_path), {"p": TensorTreeState({"w": w}), "prog": StateDict(step=9)}
    )
    snapshot = pending.wait()
    assert pending.done() and pending.staged()
    assert pending.visible_s <= pending.staged_s <= pending.committed_s
    fresh = {"p": TensorTreeState({"w": torch.zeros(128)}), "prog": StateDict(step=0)}
    snapshot.restore(fresh)
    assert _bytes(fresh["p"].tree["w"]) == _bytes(w) and fresh["prog"]["step"] == 9
    # The JAX package reads what the async take wrote.
    assert jts.Snapshot(str(tmp_path)).read_object("0/p/w").tobytes() == _bytes(w)


def test_async_take_unblocks_before_io(tmp_path) -> None:
    with _patch_plugin(SlowFSStoragePlugin):
        t0 = time.monotonic()
        pending = Snapshot.async_take(str(tmp_path), {"p": TensorTreeState({"w": torch.ones(64)})})
        assert time.monotonic() - t0 < SlowFSStoragePlugin.DELAY_S
        assert not os.path.exists(tmp_path / SNAPSHOT_METADATA_FNAME)
        pending.wait()
    assert os.path.exists(tmp_path / SNAPSHOT_METADATA_FNAME)


def test_failed_async_take_leaves_no_commit_marker(tmp_path) -> None:
    plugin = _faulty_plugin(lambda path: path != SNAPSHOT_METADATA_FNAME, delay_s=0.05)
    with _patch_plugin(plugin):
        pending = Snapshot.async_take(str(tmp_path), {"p": TensorTreeState({"w": torch.ones(64)})})
        with pytest.raises(OSError, match="injected storage failure"):
            pending.wait()
    assert not os.path.exists(tmp_path / SNAPSHOT_METADATA_FNAME)
    with pytest.raises(FileNotFoundError):
        _ = Snapshot(str(tmp_path)).metadata


def test_async_take_returns_before_staging(tmp_path) -> None:
    """Device-snapshot default: the call returns after the capture; the
    (slow) staging runs on the background drain."""
    w = torch.arange(512.0)
    with _sleepy_stage(0.4):
        t0 = time.monotonic()
        pending = Snapshot.async_take(str(tmp_path), {"p": TensorTreeState({"w": w})})
        assert time.monotonic() - t0 < 0.4, "staging ran inside the visible span"
        assert pending.wait(phase="staged") is None
        assert pending.staged()
        snapshot = pending.wait()
    fresh = {"p": TensorTreeState({"w": torch.zeros(512)})}
    snapshot.restore(fresh)
    assert _bytes(fresh["p"].tree["w"]) == _bytes(w)


def test_async_take_device_snapshot_disabled_stages_before_return(tmp_path) -> None:
    w = torch.arange(64.0)
    with knobs.disable_async_device_snapshot(), _sleepy_stage(0.3):
        t0 = time.monotonic()
        pending = Snapshot.async_take(str(tmp_path), {"p": TensorTreeState({"w": w})})
        assert time.monotonic() - t0 >= 0.3, "staging was deferred despite the knob"
        assert pending.staged()
        w.fill_(-1.0)  # staged by copy: the write keeps the bytes at the call
        pending.wait()
    assert _bytes(Snapshot(str(tmp_path)).read_object("0/p/w")) == _bytes(torch.arange(64.0))


def test_async_take_wait_phase_validation_and_ordering(tmp_path) -> None:
    with _patch_plugin(SlowFSStoragePlugin):
        pending = Snapshot.async_take(str(tmp_path), {"p": TensorTreeState({"w": torch.ones(64)})})
        with pytest.raises(ValueError, match="staged"):
            pending.wait(phase="flushed")
        assert pending.wait(phase="staged") is None
        # Staged is the copy to the host, not the commit.
        assert not os.path.exists(tmp_path / SNAPSHOT_METADATA_FNAME)
        assert pending.wait(phase="committed") is not None
    assert os.path.exists(tmp_path / SNAPSHOT_METADATA_FNAME)


@pytest.mark.parametrize("shape", [(64,), (513, 257), (128, 1024)], ids=["tiny", "odd", "wide"])
def test_async_take_mutation_after_return_roundtrip(tmp_path, shape) -> None:
    """In-place updates of the live tensors the moment async_take returns
    do not reach the snapshot: the capture is the consistency point."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(shape, generator=g)
    expected = _bytes(w)
    counter = np.arange(8.0)
    pending = Snapshot.async_take(
        str(tmp_path), {"p": TensorTreeState({"w": w}), "s": StateDict(counter=counter)}
    )
    w.mul_(-2.0).add_(1.0)
    counter[:] = -1.0
    snapshot = pending.wait()
    fresh = {"p": TensorTreeState({"w": torch.zeros(shape)}), "s": StateDict(counter=np.zeros(8))}
    snapshot.restore(fresh)
    assert _bytes(fresh["p"].tree["w"]) == expected
    np.testing.assert_array_equal(fresh["s"]["counter"], np.arange(8.0))


def test_async_take_mutation_after_return_incremental(tmp_path) -> None:
    """Unchanged chunks reference the base (no capture, no write), changed
    chunks are captured: mutation after return corrupts neither."""
    base_w = torch.arange(4096.0)
    base_path = str(tmp_path / "base")
    with knobs.override_incremental_chunk_size_bytes(4096):
        Snapshot.take(base_path, {"p": TensorTreeState({"w": base_w})}, record_digests=True)
        changed = base_w.clone()
        changed[:512] = -3.0
        expected = _bytes(changed)
        pending = Snapshot.async_take(
            str(tmp_path / "incr"), {"p": TensorTreeState({"w": changed})},
            incremental_base=base_path,
        )
        changed.zero_()
        snapshot = pending.wait()
    entry = snapshot.get_manifest()["0/p/w"]
    assert [not c.array.location.startswith("../") for c in entry.chunks] == [True, False, False, False]
    fresh = {"p": TensorTreeState({"w": torch.zeros(4096)})}
    snapshot.restore(fresh)
    assert _bytes(fresh["p"].tree["w"]) == expected


def test_async_take_drain_failure_surfaces_on_every_wait(tmp_path) -> None:
    """A failure in the background drain, after a few writes succeeded,
    re-raises the same error on every wait, staged and committed alike."""
    writes = [0]

    def should_fail(path: str) -> bool:
        if path == SNAPSHOT_METADATA_FNAME:
            return False
        writes[0] += 1
        return writes[0] > 2

    state = {f"w{i}": torch.full((256,), float(i)) for i in range(8)}
    with _patch_plugin(_faulty_plugin(should_fail, delay_s=0.02)):
        pending = Snapshot.async_take(str(tmp_path), {"p": TensorTreeState(state)})
        with pytest.raises(OSError, match="injected storage failure") as e1:
            pending.wait()
        with pytest.raises(OSError) as e2:
            pending.wait()
        with pytest.raises(OSError):
            pending.wait(phase="staged")
        assert e2.value is e1.value
    assert not os.path.exists(tmp_path / SNAPSHOT_METADATA_FNAME)


def test_async_take_staging_failure_unblocks_staged_wait(tmp_path) -> None:
    def boom(self, t):
        raise RuntimeError("injected staging failure")

    with mock.patch.object(ArrayBufferStager, "_stage_host", boom):
        pending = Snapshot.async_take(str(tmp_path), {"p": TensorTreeState({"w": torch.ones(256)})})
        with pytest.raises(RuntimeError, match="injected staging failure"):
            pending.wait(phase="staged")
        with pytest.raises(RuntimeError, match="injected staging failure"):
            pending.wait()
    assert not os.path.exists(tmp_path / SNAPSHOT_METADATA_FNAME)


# ---------------------------------------------------------------------------
# async restore
# ---------------------------------------------------------------------------


def _state(seed: float):
    torch.manual_seed(int(seed))
    return {
        "params": TensorTreeState(
            {
                "w": torch.full((32, 16), seed, dtype=torch.float32),
                "b": torch.full((16,), seed * 2, dtype=torch.bfloat16),
            }
        ),
        "progress": StateDict(step=int(seed * 10), lr=0.5),
        "rng": RngState(),
    }


def test_async_restore_matches_sync(tmp_path) -> None:
    p = str(tmp_path / "snap")
    Snapshot.take(p, _state(3.0))
    rng_at_take = torch.get_rng_state()
    dest_sync = _state(0.0)
    Snapshot(p).restore(dest_sync)
    dest_async = _state(0.0)
    pending = Snapshot(p).async_restore(dest_async)
    pending.wait()
    for k in ("w", "b"):
        assert _bytes(dest_async["params"].tree[k]) == _bytes(dest_sync["params"].tree[k])
    assert dict(dest_async["progress"]) == dict(dest_sync["progress"])
    assert _bytes(torch.get_rng_state()) == _bytes(rng_at_take)


def test_leaves_untouched_until_wait(tmp_path) -> None:
    """The reads land in fresh buffers: the live tensors keep their values
    until wait() applies, and wait() writes into them in place."""
    p = str(tmp_path / "snap")
    Snapshot.take(p, _state(5.0))
    dest = _state(1.0)
    live = dest["params"].tree["w"]
    pending = Snapshot(p).async_restore(dest)
    while not pending.done():
        time.sleep(0.01)
    assert float(live[0, 0]) == 1.0
    assert dest["progress"]["step"] == 10
    pending.wait()
    assert dest["params"].tree["w"] is live and float(live[0, 0]) == 5.0


def test_wait_idempotent(tmp_path) -> None:
    p = str(tmp_path / "snap")
    Snapshot.take(p, _state(2.0))
    dest = _state(0.0)
    pending = Snapshot(p).async_restore(dest)
    pending.wait()
    dest["params"].tree["w"].fill_(7.0)
    pending.wait()  # a no-op, not a second apply
    assert float(dest["params"].tree["w"][0, 0]) == 7.0


def test_error_propagates_and_state_unmodified(tmp_path) -> None:
    p = str(tmp_path / "snap")
    Snapshot.take(p, _state(4.0))
    os.remove(os.path.join(p, "0", "params", "w"))
    dest = _state(1.0)
    pending = Snapshot(p).async_restore(dest)
    with pytest.raises(FileNotFoundError):
        pending.wait()
    assert float(dest["params"].tree["w"][0, 0]) == 1.0
    assert float(dest["params"].tree["b"][0]) == 2.0
    assert dest["progress"]["step"] == 10


def test_done_flips_after_reads(tmp_path) -> None:
    p = str(tmp_path / "snap")
    Snapshot.take(p, _state(2.0))
    pending = Snapshot(p).async_restore(_state(0.0))
    pending.wait()
    assert pending.done()


def test_async_restore_incremental_chain(tmp_path) -> None:
    """Async restore reads through ../ refs like the sync path."""
    p0, p1 = str(tmp_path / "step_0"), str(tmp_path / "step_1")
    Snapshot.take(p0, _state(1.0), record_digests=True)
    s = _state(1.0)
    s["progress"] = StateDict(step=99, lr=0.25)
    Snapshot.take(p1, s, incremental_base=p0)
    assert Snapshot(p1).get_manifest()["0/params/w"].location.startswith("../")
    dest = _state(0.0)
    Snapshot(p1).async_restore(dest).wait()
    assert float(dest["params"].tree["w"][0, 0]) == 1.0
    assert dest["progress"]["step"] == 99


# ---------------------------------------------------------------------------
# streaming placement
# ---------------------------------------------------------------------------

EVENTS = []


class RecordingFSStoragePlugin(FSStoragePlugin):
    async def _record(self, path):
        if path.startswith("0/"):
            EVENTS.append(("read", path))
        await asyncio.sleep(0.02)  # keep later reads in flight past flushes

    async def read(self, read_io):
        await super().read(read_io)
        await self._record(read_io.path)

    async def read_with_checksum(self, read_io):
        pages = await super().read_with_checksum(read_io)
        if pages is not None:
            await self._record(read_io.path)
        return pages


def _record_flushes(monkeypatch) -> None:
    orig = snapshot_mod._PlacementBatch.run

    def run(self):
        if self._values:
            EVENTS.append(("flush", len(self._values)))
        return orig(self)

    monkeypatch.setattr(snapshot_mod._PlacementBatch, "run", run)


def _tree(seed: float):
    return {f"w{i}": torch.full((64, 8), seed + i) for i in range(6)}


def test_streaming_placement_overlaps_reads(tmp_path, monkeypatch) -> None:
    """With a tiny flush threshold, placements run between read
    completions, not in one batch after all reads."""
    EVENTS.clear()
    _record_flushes(monkeypatch)
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_PER_RANK_IO_CONCURRENCY", "1")
    src = _tree(2.0)
    p = str(tmp_path / "snap")
    Snapshot.take(p, {"m": TensorTreeState(src)})
    dest = {k: torch.zeros_like(v) for k, v in src.items()}
    with knobs.override_restore_placement_flush_bytes(1), _patch_plugin(RecordingFSStoragePlugin):
        Snapshot(p).restore({"m": TensorTreeState(dest)})
    assert all(_bytes(dest[k]) == _bytes(src[k]) for k in src)
    flushes = [i for i, (kind, _) in enumerate(EVENTS) if kind == "flush"]
    reads = [i for i, (kind, _) in enumerate(EVENTS) if kind == "read"]
    assert len(flushes) >= 2, EVENTS
    assert flushes[0] < reads[-1], EVENTS


def test_flush_disabled_places_in_one_batch(tmp_path, monkeypatch) -> None:
    EVENTS.clear()
    _record_flushes(monkeypatch)
    src = _tree(4.0)
    p = str(tmp_path / "snap")
    Snapshot.take(p, {"m": TensorTreeState(src)})
    dest = {k: torch.zeros_like(v) for k, v in src.items()}
    with knobs.override_restore_placement_flush_bytes(0):
        Snapshot(p).restore({"m": TensorTreeState(dest)})
    assert all(_bytes(dest[k]) == _bytes(src[k]) for k in src)
    assert [e for e in EVENTS if e[0] == "flush"] == [("flush", len(src))]


def test_streaming_async_restore_roundtrip(tmp_path) -> None:
    src = _tree(7.0)
    p = str(tmp_path / "snap")
    Snapshot.take(p, {"m": TensorTreeState(src)})
    dest = {k: torch.zeros_like(v) for k, v in src.items()}
    with knobs.override_restore_placement_flush_bytes(1):
        Snapshot(p).async_restore({"m": TensorTreeState(dest)}).wait()
    assert all(_bytes(dest[k]) == _bytes(src[k]) for k in src)
