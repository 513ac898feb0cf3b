"""CheckpointManager of the port: retention, latest-step resume, async
saves, metric retention, incremental chains with pinning and GC, the index
and its torn-write recovery, and the refusals of what is not ported yet.

Ports of the JAX package's ``tests/test_manager.py`` (the retention GC
fuzz with its seeds included, and its two-process cases on the port's
spawned harness, whose workers never import ``jax``)
and of the manager cases of ``tests/test_incremental.py`` (its sharded GC
case with ``DTensor``s on two gloo ranks), plus the two
packages' managers on one root in both directions: each reads, restores,
retains and incrementally extends what the other wrote. Everything is
compared bit for bit (no tolerance): a checkpoint returns the bytes it was
given.
"""

import json
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import (
    CheckpointManager,
    Snapshot,
    StateDict,
    TensorTreeState,
    knobs,
    telemetry,
)
from torchsnapshot_tpu_torch.chaos import (
    ChaosEngine,
    SimulatedCrash,
    arm,
    arm_engine,
    crash_plan,
    crashpoint,
    disarm,
    hits,
)
from torchsnapshot_tpu_torch.fsck import verify_snapshot
from torchsnapshot_tpu_torch.manager import (
    INDEX_BACKUP_BLOB,
    INDEX_BLOB,
    _step_dirname,
    referenced_steps,
)
from torchsnapshot_tpu_torch.models import transformer as tt
from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_METADATA_FNAME
from torchsnapshot_tpu_torch.telemetry import names

torch.set_num_threads(1)


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _state(value: float):
    return {"s": TensorTreeState({"w": torch.full((8,), value, dtype=torch.float64)})}


def _w(state) -> torch.Tensor:
    return state["s"].tree["w"]


def _index(root) -> dict:
    return json.loads((root / INDEX_BLOB).read_text())


def test_save_restore_latest_roundtrip(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    assert mgr.restore_latest(_state(0.0)) is None  # fresh run

    mgr.save(10, _state(10.0))
    mgr.save(20, _state(20.0))
    assert mgr.all_steps() == [10, 20]

    dst = _state(0.0)
    assert mgr.restore_latest(dst) == 20
    assert torch.equal(_w(dst), torch.full((8,), 20.0, dtype=torch.float64))

    dst = _state(0.0)
    mgr.restore(10, dst)
    assert torch.equal(_w(dst), torch.full((8,), 10.0, dtype=torch.float64))


def test_retention_deletes_old_steps(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(float(step)))
    assert mgr.all_steps() == [3, 4]

    # Dropped steps lose their commit marker and their blobs.
    for dropped in (1, 2):
        step_dir = tmp_path / _step_dirname(dropped)
        assert not (step_dir / SNAPSHOT_METADATA_FNAME).exists()
        assert not (step_dir / "0" / "s" / "w").exists()
        assert not (step_dir / "checksums" / "0").exists()
    dst = _state(0.0)
    mgr.restore(3, dst)
    assert torch.equal(_w(dst), torch.full((8,), 3.0, dtype=torch.float64))


def test_async_save_commits_on_wait(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), keep_last_n=1)
    pending = mgr.async_save(5, _state(5.0))
    pending.wait()
    pending2 = mgr.async_save(6, _state(6.0))
    pending2.wait()
    assert pending2.done()
    # The wrapped handle's phase times pass through.
    assert 0 <= pending2.visible_s <= pending2.staged_s <= pending2.committed_s
    assert mgr.all_steps() == [6]
    dst = _state(0.0)
    assert mgr.restore_latest(dst) == 6


def test_async_save_staged_wait_does_not_index(tmp_path) -> None:
    """wait(phase="staged") observes the end of the copies only: the step
    does not enter the index; the committed wait indexes it exactly once."""
    mgr = CheckpointManager(str(tmp_path))
    pending = mgr.async_save(3, _state(3.0))
    assert pending.wait(phase="staged") is None
    assert pending.staged()
    assert 3 not in mgr.all_steps()
    with pytest.raises(ValueError, match="staged"):
        pending.wait(phase="stagd")
    snapshot = pending.wait()
    assert snapshot is not None
    assert mgr.all_steps() == [3]
    before = telemetry.metrics().counters_snapshot()[names.MANAGER_SAVES_TOTAL]
    pending.wait()  # idempotent: no second commit
    assert telemetry.metrics().counters_snapshot()[names.MANAGER_SAVES_TOTAL] == before
    assert mgr.all_steps() == [3]


def test_uncommitted_step_invisible(tmp_path) -> None:
    """A step directory without a commit marker (a crashed take) never
    appears in the index and is never restored."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1.0))
    fake = tmp_path / _step_dirname(2) / "0" / "s"
    fake.mkdir(parents=True)
    (fake / "w").write_bytes(b"\x00" * 64)
    assert mgr.all_steps() == [1]
    dst = _state(0.0)
    assert mgr.restore_latest(dst) == 1


def test_index_blob_location(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, _state(7.0))
    assert (tmp_path / INDEX_BLOB).exists()


def test_memory_backend() -> None:
    from torchsnapshot_tpu_torch.storage_plugins import memory

    try:
        mgr = CheckpointManager("memory://mgrtest", keep_last_n=1)
        mgr.save(1, _state(1.0))
        mgr.save(2, _state(2.0))
        assert mgr.all_steps() == [2]
        dst = _state(0.0)
        assert mgr.restore_latest(dst) == 2
        assert torch.equal(_w(dst), torch.full((8,), 2.0, dtype=torch.float64))
    finally:
        for name in [n for n in memory._STORES if n.startswith("mgrtest")]:
            memory.MemoryStoragePlugin.drop_store(name)


def test_corrupt_index_falls_back_to_backup(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1.0))
    mgr.save(2, _state(2.0))
    assert (tmp_path / INDEX_BACKUP_BLOB).exists()
    (tmp_path / INDEX_BLOB).write_text("{trunc")  # torn primary write
    assert mgr.all_steps() == [1, 2]
    dst = _state(0.0)
    assert mgr.restore_latest(dst) == 2


def test_saving_older_step_is_never_deleted(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    mgr.save(9, _state(9.0))
    mgr.save(10, _state(10.0))
    mgr.save(5, _state(5.0))
    assert 5 in mgr.all_steps()
    dst = _state(0.0)
    mgr.restore(5, dst)
    assert torch.equal(_w(dst), torch.full((8,), 5.0, dtype=torch.float64))


def test_unreadable_index_fails_save_instead_of_orphaning(tmp_path, monkeypatch) -> None:
    """Transiently unreadable index slots are not an empty step list: a save
    in that state would orphan every committed step."""
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1.0))
    mgr.save(2, _state(2.0))
    real_read = FSStoragePlugin.read

    async def flaky_read(self, read_io):
        if "index" in read_io.path:
            raise OSError("transient storage blip")
        return await real_read(self, read_io)

    monkeypatch.setattr(FSStoragePlugin, "read", flaky_read)
    with pytest.raises(Exception, match="index unreadable|transient"):
        mgr.save(3, _state(3.0))
    monkeypatch.setattr(FSStoragePlugin, "read", real_read)
    assert mgr.all_steps() == [1, 2]
    dst = _state(0.0)
    assert mgr.restore_latest(dst) == 2


def test_torn_first_index_write_self_recovers(tmp_path) -> None:
    (tmp_path / INDEX_BLOB).write_text("{torn")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == []
    mgr.save(1, _state(1.0))
    assert mgr.all_steps() == [1]


def test_both_index_slots_corrupt_raises(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1.0))
    (tmp_path / INDEX_BLOB).write_text("{torn")
    (tmp_path / INDEX_BACKUP_BLOB).write_text("{torn")
    with pytest.raises(RuntimeError, match="index unreadable"):
        mgr.all_steps()


# ---------------------------------------------------------------------------
# metric-based retention (keep_best_n)
# ---------------------------------------------------------------------------


def _mstate(v: float):
    return {"m": TensorTreeState({"w": torch.full((8,), float(v))})}


def test_keep_best_n_retains_best_and_last(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), keep_last_n=1, keep_best_n=2, best_mode="min")
    losses = {0: 5.0, 1: 1.0, 2: 4.0, 3: 0.5, 4: 9.0}
    for step, loss in losses.items():
        mgr.save(step, _mstate(step), metric=loss)
    assert mgr.all_steps() == [1, 3, 4]
    assert mgr.best_step() == 3
    dest = _mstate(-1)
    assert mgr.restore_best(dest) == 3
    assert float(dest["m"].tree["w"][0]) == 3.0


def test_keep_best_max_mode_and_ties(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), keep_best_n=1, best_mode="max")
    mgr.save(0, _mstate(0), metric=0.9)
    mgr.save(1, _mstate(1), metric=0.9)  # tie: the newest wins
    mgr.save(2, _mstate(2), metric=0.1)
    mgr.save(3, _mstate(3), metric=0.2)
    assert mgr.best_step() == 1
    assert 1 in mgr.all_steps()
    assert 0 not in mgr.all_steps()
    assert 2 not in mgr.all_steps()


def test_metricless_steps_protected_only_by_last_n(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2, keep_best_n=1)
    mgr.save(0, _mstate(0), metric=1.0)
    mgr.save(1, _mstate(1))
    mgr.save(2, _mstate(2))
    mgr.save(3, _mstate(3))
    assert mgr.all_steps() == [0, 2, 3]
    assert mgr.best_step() == 0


def test_keep_best_alone_never_gcs_unscored_steps(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), keep_best_n=1)
    mgr.save(0, _mstate(0))
    mgr.save(1, _mstate(1), metric=2.0)
    mgr.save(2, _mstate(2))
    mgr.save(3, _mstate(3), metric=1.0)  # a new best: step 1 drops
    assert mgr.all_steps() == [0, 2, 3]
    assert mgr.best_step() == 3


def test_best_step_none_without_metrics(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, _mstate(0))
    assert mgr.best_step() is None
    assert mgr.restore_best(_mstate(-1)) is None


def test_async_save_metric_recorded(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), keep_best_n=1)
    mgr.async_save(0, _mstate(0), metric=3.0).wait()
    mgr.async_save(1, _mstate(1), metric=2.0).wait()
    assert mgr.best_step() == 1


def test_best_retention_composes_with_incremental_pins(tmp_path) -> None:
    """A best-kept step that references an origin keeps the origin pinned."""

    def st(t):
        return {
            "m": TensorTreeState({"frozen": torch.arange(32.0), "t": torch.full((4,), float(t))})
        }

    mgr = CheckpointManager(str(tmp_path), keep_last_n=1, keep_best_n=1, incremental=True)
    mgr.save(0, st(0), metric=5.0)
    mgr.save(1, st(1), metric=0.1)  # the best; refs step 0's frozen blob
    mgr.save(2, st(2), metric=7.0)
    mgr.save(3, st(3), metric=8.0)
    steps = mgr.all_steps()
    assert 1 in steps and 3 in steps and 2 not in steps
    dest = st(-1)
    assert mgr.restore_best(dest) == 1
    assert torch.equal(dest["m"].tree["frozen"], torch.arange(32.0))


def test_nonfinite_metric_rejected(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), keep_best_n=1)
    with pytest.raises(ValueError, match="finite"):
        mgr.save(0, _mstate(0), metric=float("nan"))
    with pytest.raises(ValueError, match="finite"):
        mgr.async_save(0, _mstate(0), metric=float("inf"))
    assert mgr.all_steps() == []


@pytest.mark.parametrize("seed", range(3))
def test_retention_gc_fuzz_every_indexed_step_restores(tmp_path, seed) -> None:
    """Randomized save sequences (incremental on or off, random metrics,
    random keep_last_n / keep_best_n), the JAX package's generator and
    seeds: after every save, every step in the index restores byte-exact
    and deep-fscks clean. Retention with ref-pinning GC never deletes
    blobs a live step references."""
    rng = np.random.default_rng(6000 + seed)
    keep_last = int(rng.integers(1, 4)) if rng.random() < 0.7 else None
    keep_best = int(rng.integers(1, 3)) if rng.random() < 0.5 else None
    incremental = bool(rng.random() < 0.6)
    mgr = CheckpointManager(
        str(tmp_path / "root"), keep_last_n=keep_last, keep_best_n=keep_best,
        incremental=incremental,
    )
    base = rng.standard_normal(3000).astype(np.float32)
    states = {}
    with knobs.override_incremental_chunk_size_bytes(256):
        for step in range(8):
            arr = base.copy()
            idx = rng.integers(0, arr.size, 20)  # sparse: refs chain
            arr[idx] = rng.standard_normal(20)
            base = arr
            states[step] = arr.copy()
            metric = float(rng.standard_normal()) if rng.random() < 0.7 else None
            mgr.save(step, {"m": TensorTreeState({"w": torch.from_numpy(arr.copy())})}, metric=metric)

            for s in mgr.all_steps():
                dst = TensorTreeState({"w": torch.zeros(3000)})
                Snapshot(mgr.step_path(s)).restore({"m": dst})
                assert dst.tree["w"].numpy().tobytes() == states[s].tobytes()
                report = verify_snapshot(mgr.step_path(s), deep=True)
                assert report.ok, (s, report)


# ---------------------------------------------------------------------------
# incremental chains: the manager cases of tests/test_incremental.py
# ---------------------------------------------------------------------------


def _istate(v_w, v_t):
    return {
        "m": TensorTreeState(
            {"w": torch.full((64,), float(v_w)), "t": torch.full((32,), float(v_t))}
        )
    }


def test_manager_incremental_chain_and_restore(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path / "ckpts"), incremental=True)
    mgr.save(0, _istate(1, 1))
    mgr.save(1, _istate(1, 2))  # only t changes
    mgr.save(2, _istate(1, 3))
    man2 = Snapshot(mgr.step_path(2)).get_manifest()
    assert man2["0/m/w"].location == "../step_0000000000/0/m/w"
    assert not man2["0/m/t"].location.startswith("../")
    dest = _istate(0, 0)
    assert mgr.restore_latest(dest) == 2
    assert float(dest["m"].tree["w"][0]) == 1.0
    assert float(dest["m"].tree["t"][0]) == 3.0


def test_manager_retention_pins_referenced_base(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep_last_n=2, incremental=True)
    for step in range(4):
        mgr.save(step, _istate(1, step))  # w never changes: refs step 0
    index = _index(tmp_path / "ckpts")
    assert index["steps"] == [2, 3]
    assert index["pinned"] == [0]
    assert os.path.exists(os.path.join(mgr.step_path(0), "0", "m", "w"))
    assert not os.path.exists(os.path.join(mgr.step_path(1), "0", "m", "t"))
    dest = _istate(0, 0)
    assert mgr.restore_latest(dest) == 3
    assert float(dest["m"].tree["w"][0]) == 1.0
    assert float(dest["m"].tree["t"][0]) == 3.0


def test_manager_cascade_deletes_unreferenced_pin(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep_last_n=2, incremental=True)
    for step in range(4):
        mgr.save(step, _istate(1, step))  # pins step 0 (w's origin)
    assert os.path.exists(os.path.join(mgr.step_path(0), "0", "m", "w"))
    # w changes: new steps stop referencing step 0, so its pin is released
    # and its blobs are deleted.
    mgr.save(4, _istate(2, 4))
    mgr.save(5, _istate(2, 5))
    index = _index(tmp_path / "ckpts")
    assert index["steps"] == [4, 5]
    assert index.get("pinned", []) in ([4], [])
    assert not os.path.exists(os.path.join(mgr.step_path(0), "0", "m", "w"))
    dest = _istate(0, 0)
    assert mgr.restore_latest(dest) == 5
    assert float(dest["m"].tree["w"][0]) == 2.0
    assert float(dest["m"].tree["t"][0]) == 5.0


def test_manager_async_incremental(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path / "ckpts"), incremental=True)
    mgr.async_save(0, _istate(1, 1)).wait()
    mgr.async_save(1, _istate(1, 2)).wait()
    man1 = Snapshot(mgr.step_path(1)).get_manifest()
    assert man1["0/m/w"].location.startswith("../step_0000000000")
    assert _index(tmp_path / "ckpts")["refs"]["1"] == [0]


def test_manager_old_index_format_still_reads(tmp_path) -> None:
    root = tmp_path / "ckpts"
    mgr = CheckpointManager(str(root))
    mgr.save(0, _istate(1, 1))
    (root / INDEX_BLOB).write_text(json.dumps({"steps": [0]}))
    (root / INDEX_BACKUP_BLOB).write_text(json.dumps({"steps": [0]}))
    assert mgr.all_steps() == [0]
    mgr.save(1, _istate(1, 2))
    assert mgr.all_steps() == [0, 1]


def test_old_index_refs_rederived_before_gc(tmp_path) -> None:
    """An index written before refs were recorded: GC re-derives a retained
    step's refs from its manifest and pins its base instead of deleting it."""
    root = tmp_path / "ckpts"
    mgr = CheckpointManager(str(root), incremental=True)
    mgr.save(0, _istate(1, 1))
    mgr.save(1, _istate(1, 2))  # refs step 0
    for slot in (INDEX_BLOB, INDEX_BACKUP_BLOB):
        (root / slot).write_text(json.dumps({"steps": [0, 1]}))
    CheckpointManager(str(root), keep_last_n=1).save(2, _istate(3, 3), incremental=True)
    # keep_last_n=1 keeps step 2 (every leaf changed: it refs nothing), so
    # steps 0 and 1 both go.
    assert mgr.all_steps() == [2]
    assert not (root / _step_dirname(0) / "0" / "m" / "w").exists()
    mgr2 = CheckpointManager(str(root), keep_last_n=2, incremental=True)
    mgr2.save(3, _istate(3, 4))  # refs step 2's w
    for slot in (INDEX_BLOB, INDEX_BACKUP_BLOB):
        (root / slot).write_text(json.dumps({"steps": [2, 3]}))
    mgr2.save(4, _istate(5, 5))
    # Step 2 dropped, but step 3 (retained) references it: pinned.
    assert mgr2.all_steps() == [3, 4]
    assert _index(root)["pinned"] == [2]
    assert verify_snapshot(mgr2.step_path(3), deep=True).ok


def test_manager_non_incremental_unaffected(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path / "ckpts"))
    mgr.save(0, _istate(1, 1))
    mgr.save(1, _istate(1, 2))
    man1 = Snapshot(mgr.step_path(1)).get_manifest()
    assert not man1["0/m/w"].location.startswith("../")
    index = _index(tmp_path / "ckpts")
    assert "refs" not in index and "pinned" not in index


# ---------------------------------------------------------------------------
# the refusals of what is not ported yet
# ---------------------------------------------------------------------------


def _tiered(tmp_path):
    return CheckpointManager(f"tiered://{tmp_path / 'fast'}|{tmp_path / 'durable'}")


def _tiered_round_trip(tmp_path, monkeypatch):
    """A tiered root: the step commits on the fast tier, is mirrored, and
    restores from the durable tier once the fast tier is gone."""
    import shutil

    from torchsnapshot_tpu_torch.tiered import reset_mirror

    mgr = _tiered(tmp_path)
    mgr.save(1, _state(1.0))
    mgr.wait_durable(1, timeout=60)
    reset_mirror()
    shutil.rmtree(tmp_path / "fast")
    fresh = _state(0.0)
    assert _tiered(tmp_path).restore_latest(fresh) == 1 and torch.equal(_w(fresh), _w(_state(1.0)))
    assert _index(tmp_path / "durable")["steps"] == [1]


def _armed_save_is_killed(tmp_path, monkeypatch):
    """An armed crash point kills the save there: the step is committed
    (the point is after its commit marker) but not indexed."""
    mgr = CheckpointManager(str(tmp_path))
    engine = arm("index-written")
    try:
        with pytest.raises(SimulatedCrash):
            mgr.save(1, _state(1.0))
    finally:
        disarm()
    assert engine.fired == [("crashpoint", "index-written", "crash")]
    # The kill came after both index slots landed: the step is indexed.
    assert CheckpointManager(str(tmp_path)).all_steps() == [1]


def _cas_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_CAS", "1")
    return CheckpointManager(str(tmp_path))


def _chunk_store_on_disk(tmp_path, monkeypatch):
    (tmp_path / "chunks").mkdir()
    return CheckpointManager(str(tmp_path))


def _cdn_knob(tmp_path, monkeypatch):
    """With the CDN and CAS knobs on, every committed step (sync and async)
    is announced on the topic with its manifest's chunk set."""
    from torchsnapshot_tpu_torch.cas import chunk_refs
    from torchsnapshot_tpu_torch.cdn import read_announce, read_head
    from torchsnapshot_tpu_torch.dist_store import InProcessStore

    monkeypatch.setenv("TORCHSNAPSHOT_TPU_CDN", "1")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_CAS", "1")
    store = InProcessStore()
    mgr = CheckpointManager(str(tmp_path), cdn_topic="weights", cdn_store=store)
    mgr.save(1, _state(1.0))
    mgr.async_save(2, _state(2.0)).wait()
    assert read_head(store, "weights") == 2
    for seq, step in ((1, 1), (2, 2)):
        ann = read_announce(store, "weights", seq)
        assert ann is not None and ann.step == step
        assert ann.chunks == chunk_refs(Snapshot(mgr.step_path(step)).metadata.manifest) != {}


def _slo_hook(tmp_path, monkeypatch):
    """With the ledger and the SLO engine on and a restore budget below
    any real restore, the commit after a restore posts one
    ``slo-breach`` for ``restore-wall``, and the next commit, still
    burning, posts none: the event is edge-triggered."""
    from torchsnapshot_tpu_torch.telemetry import ledger, slo

    ledger.reset_owned_roots()
    slo.reset_slo_state()
    try:
        # The overhead objective off: back-to-back test saves are all
        # checkpoint overhead.
        with knobs.enable_ledger(), knobs.enable_slo(), knobs.override_slo_windows(2, 4), (
            knobs.override_slo_restore_seconds(1e-9)
        ), knobs.override_slo_overhead_fraction(0):
            mgr = CheckpointManager(str(tmp_path))
            mgr.save(1, _state(1.0))
            assert mgr.restore_latest(_state(0.0)) == 1
            mgr.save(2, _state(2.0))
            mgr.async_save(3, _state(3.0)).wait()
            breaches = [
                r for r in ledger.load_ledger(ledger.find_ledger_for(str(tmp_path)))
                if r["event"] == names.EVENT_SLO_BREACH
            ]
    finally:
        ledger.reset_owned_roots()
        slo.reset_slo_state()
    assert [(r["objective"], r["step"]) for r in breaches] == [("restore-wall", 2)]


def _autotune_hook(tmp_path, monkeypatch):
    """With the autotuner on, each commit (sync and async) logs one
    decision in ``.tuner-state.json`` and installs its vector."""
    from torchsnapshot_tpu_torch.tuner import current_vector, load_state

    with knobs.enable_autotune():
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, _state(1.0))
        mgr.async_save(2, _state(2.0)).wait()
        state = load_state(str(tmp_path))
        assert [d["step"] for d in state.decisions] == [1, 2]
        assert knobs.get_tuner_overrides() and state.vector == current_vector()
    assert not knobs.get_tuner_overrides()


def _fleet_root(tmp_path, run):
    """A root that advertises a live coordination store (``.fleet-endpoint``)
    holding one publisher's fleet snapshot; ``run(port)`` is the CLI."""
    from torchsnapshot_tpu_torch.dist_store import TCPStore
    from torchsnapshot_tpu_torch.telemetry import wire

    store = TCPStore("127.0.0.1", 0, is_server=True)
    reporter = wire.FleetReporter(store, "publisher", "topic", interval_s=0)
    try:
        assert reporter.publish(force=True)
        wire.write_fleet_endpoint(str(tmp_path), "127.0.0.1", store.port)
        assert run(store.port) == 0
    finally:
        reporter.close()
        store.close()


def _doctor_fleet(tmp_path, monkeypatch):
    from torchsnapshot_tpu_torch.telemetry.doctor import main

    _fleet_root(tmp_path, lambda port: main([str(tmp_path), "--fleet"]))


def _telemetry_fleet(tmp_path, monkeypatch):
    from torchsnapshot_tpu_torch.telemetry.stats import main

    _fleet_root(tmp_path, lambda port: main(["fleet", f"127.0.0.1:{port}", "--once"]))


@pytest.mark.parametrize(
    "make, step",
    [
        (_tiered_round_trip, "ported"),
        (_cas_knob, None),
        (_chunk_store_on_disk, None),
        (_cdn_knob, "ported"),
        (lambda tmp_path, mp: CheckpointManager(str(tmp_path)).wait_durable(0), "noop"),
        (lambda tmp_path, mp: CheckpointManager(str(tmp_path)).resume_mirrors(), "noop"),
        (_armed_save_is_killed, "ported"),
        (_slo_hook, "ported"),
        (_autotune_hook, "ported"),
        (_doctor_fleet, "ported"),
        (_telemetry_fleet, "ported"),
    ],
    ids=[
        "tiered", "cas", "chunk-store", "cdn", "wait-durable", "resume-mirrors", "crashpoint-arm", "slo",
        "autotune", "doctor-fleet", "telemetry-fleet",
    ],
)
def test_unported_features_are_refused(tmp_path, monkeypatch, make, step) -> None:
    """Every feature the manager once refused is ported now; the SLO
    evaluation and the autotuner run after each commit, sync and async,
    and ``doctor --fleet`` / ``telemetry fleet`` read a root's advertised
    fleet plane (``.fleet-endpoint``). The chunk
    store (the ``cas`` and ``chunk-store`` cases): a manager with the CAS
    knob on, or over a root that holds a chunk store, saves into the store
    and restores from it. The tiered root, crash-point arming and the CDN
    publish side run their behaviour in ``make``; on a plain root
    ``wait_durable`` / ``resume_mirrors`` are no-ops, as in the JAX
    manager: the step was durable at its commit, and there is no mirror to
    resume."""
    if step == "ported":
        make(tmp_path, monkeypatch)
        return
    if step == "noop":
        assert make(tmp_path, monkeypatch) in (None, [])
        assert not (tmp_path / INDEX_BLOB).exists()
        return
    if step is None:
        # With the knob (the cas case) the step's data goes to the store;
        # a root holding a store, knob off, is managed in the plain layout.
        mgr = make(tmp_path, monkeypatch)
        mgr.save(1, _state(1.0))
        fresh = _state(0.0)
        assert mgr.restore_latest(fresh) == 1 and torch.equal(_w(fresh), _w(_state(1.0)))
        in_store = [e.location.startswith("../chunks/") for e in _locations(mgr.step_path(1))]
        assert in_store and all(in_store) == knobs.is_cas_enabled() and any(in_store) == all(in_store)


def _locations(step_path: str) -> list:
    return [e for e in Snapshot(step_path).metadata.manifest.values() if getattr(e, "location", None)]


def test_knobs_off_and_cdn_topic_alone_are_inert(tmp_path) -> None:
    """With the knobs at their defaults, as the JAX manager does, a CDN
    topic without the CDN knob publishes nothing and refuses nothing."""
    assert not knobs.is_cas_enabled() and not knobs.is_cdn_enabled()
    mgr = CheckpointManager(str(tmp_path), cdn_topic="weights", keep_peer_last_n=1)
    mgr.save(1, _state(1.0))
    assert mgr.all_steps() == [1]


def test_crashpoints_declared_and_unarmed() -> None:
    """The manager's crash points are declared in the CRASH_* registry and
    are no-ops unarmed; an armed engine counts the hits and kills at its
    plan's point."""
    declared = {v for k, v in vars(names).items() if k.startswith("CRASH_")}
    assert {"index-backup-written", "index-written", "gc-marker-deleted"} <= declared
    for name in declared:
        crashpoint(name)
    arm_engine(ChaosEngine(crash_plan("gc-marker-deleted", after=1)))
    try:
        crashpoint("gc-marker-deleted")
        with pytest.raises(SimulatedCrash):
            crashpoint("gc-marker-deleted")
        assert hits("gc-marker-deleted") == 2
    finally:
        disarm()
    crashpoint("gc-marker-deleted")


# ---------------------------------------------------------------------------
# one root, two packages
# ---------------------------------------------------------------------------

CHUNK = 16 * 1024


def _model(seed: int):
    cfg = tt.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=256, attn_impl="flash"
    )
    return tt.Transformer(cfg, device="cpu", seed=seed)


def _touch(model, k: float) -> None:
    with torch.no_grad():
        model.layers[0].wo.add_(k)


def _same_params(a, b) -> None:
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert _bytes(x) == _bytes(y), n


def _data_blobs(step_dir: str) -> set:
    out = set()
    for d, _, files in os.walk(step_dir):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), step_dir)
            if not rel.startswith((SNAPSHOT_METADATA_FNAME, "checksums")):
                out.add(rel)
    return out


def _ref_origins(manifest) -> dict:
    """Logical path -> the set of origin locations' prefixes (None for a
    blob of the step itself), per leaf."""
    from torchsnapshot_tpu_torch.manifest import entry_locations

    out = {}
    for path, e in manifest.items():
        locs = entry_locations(e)
        if locs and type(e).__name__ in ("ArrayEntry", "ChunkedArrayEntry"):
            out[path] = {loc.split("/", 2)[1] if loc.startswith("../") else None for loc in locs}
    return out


@pytest.fixture
def small_chunks():
    from torchsnapshot_tpu import knobs as jknobs

    with jknobs.override_incremental_chunk_size_bytes(CHUNK), knobs.override_incremental_chunk_size_bytes(CHUNK):
        yield


def _three_saves(save, model) -> None:
    """Steps 0, 1, 2 of a run whose only changing leaf is layer 0's wo, with
    keep_last_n=2: step 0 drops from the index but stays pinned."""
    for step, metric in ((0, 3.0), (1, 1.0), (2, 2.0)):
        if step:
            _touch(model, 1.0)
        save(step, metric)


@pytest.mark.usefixtures("small_chunks")
def test_port_manager_extends_a_jax_root(tmp_path) -> None:
    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.tricks.torch import TorchStateful

    root = str(tmp_path / "root")
    model = _model(0)
    jmgr = jts.CheckpointManager(root, keep_last_n=2, incremental=True)
    _three_saves(lambda s, m: jmgr.save(s, {"model": TorchStateful(model)}, metric=m), model)

    mgr = CheckpointManager(root, keep_last_n=2, incremental=True)
    assert mgr.all_steps() == jmgr.all_steps() == [1, 2]
    assert mgr.best_step() == jmgr.best_step() == 1
    assert _index(tmp_path / "root")["pinned"] == [0]
    fresh = _model(1)
    assert mgr.restore_latest({"model": fresh}) == 2
    _same_params(model, fresh)

    # Files the JAX package may leave beside a step's manifest (its event
    # log, a progress heartbeat) go with the step when the port drops it.
    for side in (".telemetry.jsonl", ".progress-rank0.json"):
        with open(os.path.join(mgr.step_path(1), side), "w") as f:
            f.write("{}\n")

    # An incremental port save on top: only layer 0's wo is written, and
    # every other leaf references the JAX-written origin step 0.
    _touch(model, 1.0)
    mgr.save(3, {"model": model})
    manifest = Snapshot(mgr.step_path(3)).get_manifest()
    origins = _ref_origins(manifest)
    assert origins.pop("0/model/layers.0.wo") == {None}
    assert origins and all(o == {"step_0000000000"} for o in origins.values()), origins
    assert referenced_steps(manifest) == {0}
    assert _data_blobs(mgr.step_path(3)) == {"0/model/layers.0.wo"}
    # Retention by the port: [2, 3], step 0 still pinned, the JAX step 1
    # deleted, commit marker and blobs.
    assert mgr.all_steps() == jmgr.all_steps() == [2, 3]
    assert _index(tmp_path / "root")["pinned"] == [0]
    assert [f for _, _, fs in os.walk(mgr.step_path(1)) for f in fs] == []
    fresh = _model(2)
    assert jmgr.restore_latest({"model": TorchStateful(fresh)}) == 3
    _same_params(model, fresh)


@pytest.mark.usefixtures("small_chunks")
def test_jax_manager_extends_a_port_root(tmp_path) -> None:
    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.tricks.torch import TorchStateful

    root = str(tmp_path / "root")
    model = _model(0)
    mgr = CheckpointManager(root, keep_last_n=2, incremental=True)
    _three_saves(lambda s, m: mgr.save(s, {"model": model}, metric=m), model)

    jmgr = jts.CheckpointManager(root, keep_last_n=2, incremental=True)
    assert jmgr.all_steps() == mgr.all_steps() == [1, 2]
    assert jmgr.best_step() == mgr.best_step() == 1
    fresh = _model(1)
    assert jmgr.restore_latest({"model": TorchStateful(fresh)}) == 2
    _same_params(model, fresh)

    # The JAX manager's incremental save references the port's origin step
    # 0; its retention pins step 0 and deletes the port's step 1.
    _touch(model, 1.0)
    jmgr.save(3, {"model": TorchStateful(model)})
    origins = _ref_origins(Snapshot(mgr.step_path(3)).get_manifest())
    assert origins.pop("0/model/layers.0.wo") == {None}
    assert all(o == {"step_0000000000"} for o in origins.values()), origins
    assert mgr.all_steps() == [2, 3]
    assert _index(tmp_path / "root")["pinned"] == [0]
    assert not os.path.exists(os.path.join(mgr.step_path(1), SNAPSHOT_METADATA_FNAME))
    assert _data_blobs(mgr.step_path(1)) == set()
    # Once nothing retained references step 0, the JAX manager deletes it.
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    jmgr.save(4, {"model": TorchStateful(model)})
    jmgr.save(5, {"model": TorchStateful(model)})
    assert mgr.all_steps() == [4, 5]
    assert _data_blobs(mgr.step_path(0)) == set()
    for s in mgr.all_steps():
        assert verify_snapshot(mgr.step_path(s), deep=True).ok
    fresh = _model(3)
    assert mgr.restore_latest({"model": fresh}) == 5
    _same_params(model, fresh)


# ---------------------------------------------------------------------------
# the slice as a whole: a training job's loop on the CPU
# ---------------------------------------------------------------------------


def test_training_loop_save_retain_preempt_resume(tmp_path) -> None:
    """The chip_smoke.py manager phase at a tiny size: a 2-layer flash
    transformer trains four steps with keep_last_n=2 and incremental saves
    (step 1 sync, step 2 async beside the next step, step 3 sync, step 4
    on a preemption request), half the model frozen after step 1. Then
    restore_latest into a fresh state from another seed: the state and
    the next step's loss are bit-identical, and the JAX package's manager
    restores the same root with equal tensors."""
    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.tricks.torch import TorchStateful

    from torchsnapshot_tpu_torch import PreemptionSaver

    cfg = tt.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=256, attn_impl="flash"
    )
    tokens = torch.from_numpy(tt.random_tokens(cfg, 2, 128, seed=0))
    state = tt.init_train_state(cfg, seed=0, device="cpu")
    train_step = tt.make_train_step(cfg)
    root = str(tmp_path / "run")
    mgr = CheckpointManager(root, keep_last_n=2, incremental=True)
    saver = PreemptionSaver(signals=())
    try:
        state, _ = train_step(state, tokens)
        assert not saver.should_save(1)
        mgr.save(1, {"train": state})
        frozen = [state.model.embed, *state.model.layers[0].parameters()]
        for p in frozen:
            p.requires_grad_(False)
        state, _ = train_step(state, tokens)
        assert not saver.should_save(2)
        pending = mgr.async_save(2, {"train": state})
        state, _ = train_step(state, tokens)  # beside the drain
        pending.wait()
        assert not saver.should_save(3)
        mgr.save(3, {"train": state})
        state, _ = train_step(state, tokens)
        saver.request_save()
        assert saver.should_save(4)
        mgr.save(4, {"train": state})
        assert saver.exit_after_save and not saver.should_save(5)
    finally:
        saver.close()
    saved = {k: v.clone() for k, v in _train_tensors(state).items()}

    assert mgr.all_steps() == [3, 4]
    refs = {s: referenced_steps(Snapshot(mgr.step_path(s)).metadata.manifest) for s in (3, 4)}
    assert refs == {3: {1}, 4: {1}}, refs
    assert _index(tmp_path / "run")["pinned"] == [1]
    assert _data_blobs(mgr.step_path(2)) == set()
    for s in (3, 4):
        assert verify_snapshot(mgr.step_path(s), deep=True).ok

    fresh = tt.init_train_state(cfg, seed=1, device="cpu")
    assert mgr.restore_latest({"train": fresh}) == 4
    for k, v in _train_tensors(fresh).items():
        assert _bytes(v) == _bytes(saved[k]), k
    for p in [fresh.model.embed, *fresh.model.layers[0].parameters()]:
        p.requires_grad_(False)
    _, loss_a = train_step(state, tokens)
    _, loss_b = train_step(fresh, tokens)
    assert _bytes(loss_a) == _bytes(loss_b)

    jfresh = tt.init_train_state(cfg, seed=2, device="cpu")
    assert jts.CheckpointManager(root).restore_latest({"train": TorchStateful(jfresh)}) == 4
    for k, v in _train_tensors(jfresh).items():
        assert _bytes(v) == _bytes(saved[k]), k


def _train_tensors(state) -> dict:
    out = {f"param/{n}": p for n, p in state.model.named_parameters()}
    for i, s in state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            out[f"opt/{i}/{k}"] = v
    out["rng"] = state.rng.get_state()
    return out


def test_statedict_progress_roundtrips_through_the_manager(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), keep_last_n=1)
    mgr.save(1, {"progress": StateDict(step=1, epoch=0)})
    dst = {"progress": StateDict(step=-1)}
    assert mgr.restore_latest(dst) == 1
    assert dict(dst["progress"]) == {"step": 1, "epoch": 0}


# ---------------------------------------------------------------------------
# Across processes
# ---------------------------------------------------------------------------


def _mgr_worker(pg, root: str):
    import shutil

    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    if pg.rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    PGWrapper(pg).barrier()  # both ranks see the clean root
    mgr = CheckpointManager(root, keep_last_n=2, pg=pg)
    state = {"s": TensorTreeState({"w": torch.full((4,), float(pg.rank))})}
    assert mgr.restore_latest(state) is None  # fresh: broadcast + early return
    mgr.save(3, state)
    PGWrapper(pg).barrier()  # rank 0's index write is durable
    dst = {"s": TensorTreeState({"w": torch.zeros(4)})}
    resumed = mgr.restore_latest(dst)
    assert torch.equal(dst["s"].tree["w"], torch.full((4,), float(pg.rank)))  # per-rank state
    return resumed


def test_multiprocess_fresh_restore_then_save(tmp_path) -> None:
    """restore_latest on a fresh run (a broadcast, an early return, no
    trailing barrier) at once followed by save's own broadcasts: the
    shared op sequence keeps every store key unique, or a slow rank
    would read the wrong object."""
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    assert run_multiprocess(_mgr_worker, nproc=2, args=(str(tmp_path / "root"),)) == [3, 3]


def _mgr_async_worker(pg, root: str):
    import shutil

    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    if pg.rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    PGWrapper(pg).barrier()
    mgr = CheckpointManager(root, keep_last_n=2, pg=pg)
    for step in (1, 2, 3):
        state = {
            "s": TensorTreeState({"w": torch.full((4,), float(step))}),
            "progress": StateDict(rank=pg.rank),
        }
        mgr.async_save(step, state).wait()
    PGWrapper(pg).barrier()  # rank 0's index write is durable everywhere
    steps = sorted(mgr.all_steps())
    dst = {"s": TensorTreeState({"w": torch.zeros(4)}), "progress": StateDict(rank=-1)}
    assert mgr.restore_latest(dst) == 3
    assert torch.equal(dst["s"].tree["w"], torch.full((4,), 3.0))
    assert dst["progress"]["rank"] == pg.rank  # per-rank state stayed per-rank
    return steps


def test_multiprocess_async_save_and_retention(tmp_path) -> None:
    """async_save across processes: the background commits of both ranks
    meet at the store barrier, retention runs on rank 0 inside wait(),
    and the next resume sees exactly the retained steps."""
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    results = run_multiprocess(_mgr_async_worker, nproc=2, args=(str(tmp_path / "root"),))
    assert results == [[2, 3], [2, 3]]


def _mgr_incremental_replicated_worker(pg, root: str):
    """Incremental managed saves of replicated and per-rank state across
    two ranks: the replicated leaf's skip decision agrees on both ranks,
    an unchanged replicated chunk is referenced, not rewritten."""
    import shutil

    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    if pg.rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    PGWrapper(pg).barrier()
    mgr = CheckpointManager(root, keep_last_n=2, pg=pg, incremental=True)
    frozen = torch.arange(4096.0)
    for step in (1, 2):
        state = {
            "m": TensorTreeState({"frozen": frozen, "hot": torch.full((512,), float(step))}),
            "own": TensorTreeState({"x": torch.full((64,), float(10 * step + pg.rank))}),
        }
        mgr.save(step, state, replicated=["m/**"])
    PGWrapper(pg).barrier()
    dst = {
        "m": TensorTreeState({"frozen": torch.zeros(4096), "hot": torch.zeros(512)}),
        "own": TensorTreeState({"x": torch.zeros(64)}),
    }
    assert mgr.restore_latest(dst) == 2
    assert torch.equal(dst["m"].tree["frozen"], frozen)
    assert torch.equal(dst["m"].tree["hot"], torch.full((512,), 2.0))
    assert torch.equal(dst["own"].tree["x"], torch.full((64,), 20.0 + pg.rank))
    manifest = Snapshot(mgr.step_path(2)).metadata.manifest
    return (
        manifest["0/m/frozen"].location,
        manifest["0/m/hot"].location,
        "1/m/frozen" in manifest,
        sorted(referenced_steps(manifest)),
    )


def test_multiprocess_incremental_replicated_saves(tmp_path) -> None:
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    results = run_multiprocess(
        _mgr_incremental_replicated_worker, nproc=2, args=(str(tmp_path / "root"),)
    )
    assert results[0] == results[1]
    frozen_loc, hot_loc, dup, refs = results[0]
    assert frozen_loc == "../step_0000000001/replicated/m/frozen"
    assert hot_loc == "replicated/m/hot"
    assert not dup and refs == [1]


def _mgr_sharded_worker(pg, root: str) -> list:
    """Two ranks save row-sharded DTensors with keep_last_n=1."""
    import torch.distributed as dist

    from test_torch_resharding import Meshes
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
    from torchsnapshot_tpu_torch.test_utils import init_torch_group

    init_torch_group(pg)
    try:
        meshes = Meshes(pg.world_size)
        mgr = CheckpointManager(root, keep_last_n=1, pg=pg)
        for step, v in ((1, 1.0), (2, 2.0)):
            emb = meshes.dtensor(torch.full((8 * pg.world_size, 4), v), "row2")
            mgr.save(step, {"s": TensorTreeState({"emb": emb})})
        PGWrapper(pg).barrier()  # rank 0's index write is durable
        return mgr.all_steps()
    finally:
        dist.destroy_process_group()


def test_sharded_and_checksums_gced(tmp_path) -> None:
    """Retention walks every manifest entry kind: a dropped step's shard
    blobs (written by both ranks) and checksum tables go too."""
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    root = tmp_path / "root"
    assert run_multiprocess(_mgr_sharded_worker, nproc=2, args=(str(root),)) == [[2], [2]]
    step1, step2 = root / _step_dirname(1), root / _step_dirname(2)
    assert sorted(p.name for p in (step2 / "sharded" / "s").iterdir()) == ["emb_0_0", "emb_8_0"]
    assert (step2 / "checksums" / "1").exists()
    assert not (step1 / SNAPSHOT_METADATA_FNAME).exists()
    assert not (step1 / "checksums" / "0").exists() and not (step1 / "checksums" / "1").exists()
    assert not (step1 / "sharded").exists() or not [p for p in (step1 / "sharded").rglob("*") if p.is_file()]
    dst = {"s": TensorTreeState({"emb": torch.zeros(16, 4)})}
    assert CheckpointManager(str(root)).restore_latest(dst) == 2
    assert torch.equal(dst["s"].tree["emb"], torch.full((16, 4), 2.0))
