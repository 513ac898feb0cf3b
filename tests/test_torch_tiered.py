"""Tiered roots in the port (``tiered/``): the fast commit decoupled from
the durable tier's bandwidth, the crash-consistent resume of the mirror
from its journal, the per-blob durable fallback, and the manager's
fast-tier retention, durability barrier and mirror resume.

Port of the JAX package's ``tests/test_tiered.py``: its 17 tier-1 cases,
and its slow training-loop case, still slow-marked. Added here, across
the two packages: each restores and fscks the other's durable tree after
the fast tier is lost entirely, each package's mirror resumes the other's
journal and ships only the blobs the journal lacks, the journal's JSON is
the same document both ways, and a port-mirrored root holds the run
ledger and mirror trace a JAX-mirrored one holds.
Everything is compared bit for bit.
"""

import asyncio
import json
import os
import shutil
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import (
    CheckpointManager,
    PreemptionSaver,
    Snapshot,
    TensorTreeState,
    knobs,
    telemetry,
    verify_snapshot,
)
from torchsnapshot_tpu_torch.telemetry import names
from torchsnapshot_tpu_torch.storage_plugin import join_path, split_tiered_url, url_to_storage_plugin
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.test_utils import faulty_fs_plugin
from torchsnapshot_tpu_torch.tiered import Mirror, TieredStoragePlugin, get_mirror, reset_mirror, wait_durable
from torchsnapshot_tpu_torch.tiered.journal import JOURNAL_BACKUP_BLOB, JOURNAL_BLOB, MirrorJournal
from torchsnapshot_tpu_torch.tiered.mirror import is_durable

torch.set_num_threads(1)

_MIRROR_PLUGINS = "torchsnapshot_tpu_torch.tiered.mirror.url_to_storage_plugin"


@pytest.fixture(autouse=True)
def _fresh_mirror():
    """Each test gets its own process-wide mirror (the worker thread and
    its job list outlive plugin instances by design)."""
    reset_mirror()
    yield
    reset_mirror()


def _tiers(tmp_path):
    fast = str(tmp_path / "fast")
    durable = str(tmp_path / "durable")
    return fast, durable, f"tiered://{fast}|{durable}"


def _leaves(n_leaves=4, size=2048, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {f"l{i}": rng.standard_normal(size).astype(np.float32) for i in range(n_leaves)}


def _state(n_leaves=4, size=2048, seed=0) -> dict:
    return {k: torch.from_numpy(v) for k, v in _leaves(n_leaves, size, seed).items()}


def _app(tree: dict) -> dict:
    return {"m": TensorTreeState({k: v.clone() for k, v in tree.items()})}


def _zeros(tree: dict) -> dict:
    return {"m": TensorTreeState({k: torch.zeros_like(v) for k, v in tree.items()})}


def _assert_equal(app: dict, tree: dict) -> None:
    for k, v in tree.items():
        assert torch.equal(app["m"].tree[k], v), k


def _mirror_factory(durable_root: str, plugin_cls):
    """Patch target for the mirror's plugin construction: durable-root
    URLs get ``plugin_cls``, everything else the real registry."""

    def factory(url):
        if url.startswith(durable_root):
            return plugin_cls(root=url)
        return url_to_storage_plugin(url)

    return factory


def _slow_fs(delay_s: float):
    class _Slow(FSStoragePlugin):
        async def write(self, write_io):
            await asyncio.sleep(delay_s)
            await super().write(write_io)

        async def write_with_checksum(self, write_io):
            await asyncio.sleep(delay_s)
            return await super().write_with_checksum(write_io)

    return _Slow


def _recording_fs(record: list):
    class _Recording(FSStoragePlugin):
        async def write(self, write_io):
            record.append(write_io.path)
            await super().write(write_io)

        async def write_with_checksum(self, write_io):
            record.append(write_io.path)
            return await super().write_with_checksum(write_io)

    return _Recording


def _fail_after(n: int):
    counter = {"n": 0}

    def should_fail(_path: str) -> bool:
        counter["n"] += 1
        return counter["n"] > n

    return should_fail


# ---------------------------------------------------------------------------
# URL grammar
# ---------------------------------------------------------------------------


def test_tiered_url_dispatch_and_join(tmp_path) -> None:
    fast, durable, url = _tiers(tmp_path)
    assert split_tiered_url(url) == (fast, durable)
    assert split_tiered_url("/plain/path") is None
    assert split_tiered_url("gs://bucket/x") is None
    with pytest.raises(ValueError, match="tiered://"):
        split_tiered_url("tiered://only-one-side")
    with pytest.raises(ValueError, match="nests"):
        split_tiered_url(f"tiered://tiered://a|b|{durable}")
    assert join_path(url, "step_0000000007") == f"tiered://{fast}/step_0000000007|{durable}/step_0000000007"
    plugin = url_to_storage_plugin(url)
    assert isinstance(plugin, TieredStoragePlugin)
    assert isinstance(plugin.fast, FSStoragePlugin)
    assert isinstance(plugin.durable, FSStoragePlugin)


def test_plugin_requires_tier_specs() -> None:
    with pytest.raises(ValueError, match="fast"):
        TieredStoragePlugin()


# ---------------------------------------------------------------------------
# the fast commit under a throttled durable tier
# ---------------------------------------------------------------------------


def test_take_commits_at_fast_tier_bandwidth_then_wait_durable(tmp_path) -> None:
    """The durable tier is slow, the take is not: durable bytes are still
    pending when take returns, and wait_durable later finds the step
    fsck- and CRC-clean on the durable tier alone."""
    fast, durable, url = _tiers(tmp_path)
    state = _state()
    mirrored = telemetry.series_key(names.SNAPSHOT_PHASE_SECONDS, {"phase": "mirroring"})

    def mirror_jobs():
        hist = telemetry.metrics().collect()["histograms"].get(mirrored)
        return hist["count"] if hist else 0

    jobs_before = mirror_jobs()
    with mock.patch(_MIRROR_PLUGINS, side_effect=_mirror_factory(durable, _slow_fs(0.25))):
        Snapshot.take(url, _app(state))
        assert os.path.exists(os.path.join(fast, ".snapshot_metadata"))
        assert not os.path.exists(os.path.join(durable, ".snapshot_metadata"))
        assert not is_durable(url)
        wait_durable(url, timeout=60)
    assert os.path.exists(os.path.join(durable, ".snapshot_metadata"))
    report = verify_snapshot(url, deep=True, tier="durable")
    assert report.ok and report.crcs_verified > 0
    journal = json.loads((tmp_path / "fast" / JOURNAL_BLOB).read_text())
    assert journal["durable_committed"] is True
    assert sorted(journal["done"]) == sorted(journal["blobs"])
    metrics = get_mirror().metrics()
    assert metrics["blobs_done"] == len(journal["blobs"])
    assert metrics["bytes_mirrored"] > 0
    assert metrics["snapshots_pending"] == 0
    assert mirror_jobs() == jobs_before + 1


def test_async_take_unblocks_before_durable_completes(tmp_path) -> None:
    fast, durable, url = _tiers(tmp_path)
    state = _state(n_leaves=3)
    with mock.patch(_MIRROR_PLUGINS, side_effect=_mirror_factory(durable, _slow_fs(0.25))):
        snapshot = Snapshot.async_take(url, _app(state)).wait()  # the fast commit only
        assert os.path.exists(os.path.join(fast, ".snapshot_metadata"))
        assert not os.path.exists(os.path.join(durable, ".snapshot_metadata"))
        wait_durable(url, timeout=60)
    dst = _zeros(state)
    snapshot.restore(dst)
    _assert_equal(dst, state)


# ---------------------------------------------------------------------------
# a kill between the fast commit and the mirror's end
# ---------------------------------------------------------------------------


def test_interrupted_mirror_resumes_from_journal_without_reupload(tmp_path) -> None:
    fast, durable, url = _tiers(tmp_path)
    state = _state(n_leaves=6, seed=3)
    faulty = faulty_fs_plugin(_fail_after(2), ops=("write",), exc_msg="injected durable outage")
    with knobs.override_mirror_progress_window_seconds(0.2), mock.patch(
        _MIRROR_PLUGINS, side_effect=_mirror_factory(durable, faulty)
    ):
        Snapshot.take(url, _app(state))
        (job,) = get_mirror().jobs_for(fast)
        assert job.wait(60)
        assert job.error is not None  # the mirror died mid-upload
        with pytest.raises(RuntimeError, match="mirror of"):
            wait_durable(url, timeout=60)

    # The fast tier restores in full, the durable tier has no commit
    # marker, and fsck names the partial mirror.
    dst = _zeros(state)
    Snapshot(url).restore(dst)
    _assert_equal(dst, state)
    assert not os.path.exists(os.path.join(durable, ".snapshot_metadata"))
    report = verify_snapshot(url, tier="durable")
    assert not report.ok
    assert report.problems[0].kind == "unmirrored"
    assert "mirror in progress" in report.problems[0].detail

    journal_before = json.loads((tmp_path / "fast" / JOURNAL_BLOB).read_text())
    done_before = set(journal_before["done"])
    assert done_before
    assert journal_before["durable_committed"] is False

    # A restarted mirror (the journal is its only state) finishes without
    # re-sending completed blobs, the commit marker last.
    resumed_writes: list = []
    restarted = Mirror()
    try:
        with mock.patch(_MIRROR_PLUGINS, side_effect=_mirror_factory(durable, _recording_fs(resumed_writes))):
            job = restarted.resume(url)
            assert job is not None
            assert job.wait(60)
            assert job.error is None
    finally:
        restarted.stop()
    assert not (set(resumed_writes) & done_before), resumed_writes
    assert resumed_writes[-1] == ".snapshot_metadata"
    assert is_durable(url)
    report = verify_snapshot(url, deep=True, tier="durable")
    assert report.ok and report.crcs_verified > 0
    assert Mirror().resume(url) is None  # the journal says complete
    # The process mirror still holds its failed job for this path; the
    # step is durable now, and a stale failure must not poison the barrier.
    wait_durable(url, timeout=10)


def test_resume_without_journal_remirrors_from_manifest(tmp_path) -> None:
    """Killed after the fast commit, before the first journal write: a
    full re-mirror driven by the fast-tier manifest."""
    fast, durable, url = _tiers(tmp_path)
    Snapshot.take(url, _app(_state(n_leaves=2)))
    wait_durable(url, timeout=60)
    shutil.rmtree(durable)
    os.remove(os.path.join(fast, JOURNAL_BLOB))
    os.remove(os.path.join(fast, JOURNAL_BACKUP_BLOB))
    restarted = Mirror()
    try:
        job = restarted.resume(url)
        assert job is not None
        assert job.wait(60)
        assert job.error is None
    finally:
        restarted.stop()
    assert is_durable(url)
    assert verify_snapshot(url, deep=True, tier="durable").ok


# ---------------------------------------------------------------------------
# per-blob fallback reads
# ---------------------------------------------------------------------------


def test_restore_falls_back_per_blob_when_fast_partially_evicted(tmp_path) -> None:
    fast, durable, url = _tiers(tmp_path)
    state = _state(n_leaves=5, seed=11)
    Snapshot.take(url, _app(state))
    wait_durable(url, timeout=60)
    dropped = 0
    for dirpath, _, files in os.walk(os.path.join(fast, "0")):
        for name in files:
            if dropped < 3:
                os.remove(os.path.join(dirpath, name))
                dropped += 1
    assert dropped == 3
    dst = _zeros(state)
    snapshot = Snapshot(url)
    snapshot.restore(dst)
    _assert_equal(dst, state)
    assert "degraded_reads" not in snapshot.restore_telemetry  # a fallback, not a heal


def test_restore_and_fsck_from_durable_after_total_fast_loss(tmp_path) -> None:
    fast, durable, url = _tiers(tmp_path)
    state = _state(n_leaves=3, seed=5)
    Snapshot.take(url, _app(state))
    wait_durable(url, timeout=60)
    shutil.rmtree(fast)
    assert verify_snapshot(url, deep=True).ok  # the composed view
    dst = _zeros(state)
    Snapshot(url).restore(dst)
    _assert_equal(dst, state)


def test_wait_durable_is_a_noop_for_plain_urls(tmp_path) -> None:
    path = str(tmp_path / "plain")
    Snapshot.take(path, _app(_state(n_leaves=1)))
    wait_durable(path, timeout=1)


def test_wait_durable_rejects_uncommitted_paths(tmp_path) -> None:
    _, _, url = _tiers(tmp_path)
    with pytest.raises(FileNotFoundError):
        wait_durable(url, timeout=1)


# ---------------------------------------------------------------------------
# CheckpointManager on a tiered root
# ---------------------------------------------------------------------------


def _w(value: float, n: int = 256) -> dict:
    return {"w": torch.full((n,), value, dtype=torch.float32)}


def test_manager_tiered_retention_eviction_and_fallback(tmp_path) -> None:
    fast, durable, root = _tiers(tmp_path)
    mgr = CheckpointManager(root, keep_last_n=5, keep_fast_last_n=1)
    for step in (1, 2, 3):
        mgr.save(step, _app(_w(float(step))))
        mgr.wait_durable(step, timeout=60)
    assert mgr.all_steps() == [1, 2, 3]

    def meta(tier: str, step: int) -> bool:
        return os.path.exists(os.path.join(tier, f"step_{step:010d}", ".snapshot_metadata"))

    # Steps beyond keep_fast_last_n left the fast tier only.
    assert [meta(fast, s) for s in (1, 2, 3)] == [False, False, True]
    assert all(meta(durable, s) for s in (1, 2, 3))
    durable_index = json.loads((tmp_path / "durable" / ".manager_index").read_text())
    assert durable_index["steps"] == [1, 2, 3]
    assert durable_index["evicted"] == [1, 2]
    dst = _zeros(_w(0.0))
    mgr.restore(1, dst)
    _assert_equal(dst, _w(1.0))
    dst = _zeros(_w(0.0))
    assert mgr.restore_latest(dst) == 3
    _assert_equal(dst, _w(3.0))


def test_manager_keep_fast_requires_tiered_root(tmp_path) -> None:
    with pytest.raises(ValueError, match="tiered"):
        CheckpointManager(str(tmp_path), keep_fast_last_n=1)


def test_manager_never_evicts_undurable_steps(tmp_path) -> None:
    """Eviction waits for the durable commit marker: with the mirror
    broken, every step keeps its fast copy whatever the policy."""
    fast, durable, root = _tiers(tmp_path)
    always_fail = faulty_fs_plugin(lambda _p: True, ops=("write",), exc_msg="durable down")
    with knobs.override_mirror_progress_window_seconds(0.1), mock.patch(
        _MIRROR_PLUGINS, side_effect=_mirror_factory(durable, always_fail)
    ):
        mgr = CheckpointManager(root, keep_last_n=5, keep_fast_last_n=1)
        for step in (1, 2, 3):
            mgr.save(step, _app(_w(1.0, 64)))
        get_mirror().drain(timeout=60)
        for step in (1, 2, 3):
            assert os.path.exists(os.path.join(fast, f"step_{step:010d}", ".snapshot_metadata"))
        index = json.loads((tmp_path / "fast" / ".manager_index").read_text())
        assert index.get("evicted", []) == []


def test_manager_resume_mirrors_after_restart(tmp_path) -> None:
    fast, durable, root = _tiers(tmp_path)
    always_fail = faulty_fs_plugin(lambda _p: True, ops=("write",), exc_msg="durable down")
    with knobs.override_mirror_progress_window_seconds(0.1), mock.patch(
        _MIRROR_PLUGINS, side_effect=_mirror_factory(durable, always_fail)
    ):
        mgr = CheckpointManager(root, keep_last_n=3)
        mgr.save(1, _app(_w(1.0, 64)))
        get_mirror().drain(timeout=60)
    assert not is_durable(mgr.step_path(1))
    reset_mirror()  # a process restart
    mgr2 = CheckpointManager(root, keep_last_n=3)
    assert mgr2.resume_mirrors() == [1]
    mgr2.wait_durable(1, timeout=60)
    assert is_durable(mgr2.step_path(1))
    assert verify_snapshot(mgr2.step_path(1), deep=True, tier="durable").ok


def test_preemption_drain_hook_runs_mirror_drain(tmp_path) -> None:
    _, _, url = _tiers(tmp_path)
    Snapshot.take(url, _app(_state(n_leaves=2)))
    saver = PreemptionSaver(signals=())
    drained = []
    saver.register_drain(lambda: drained.append(get_mirror().drain(timeout=60)))
    saver.close()
    assert drained == [True]
    assert is_durable(url)


@pytest.mark.slow
def test_slow_end_to_end_tiered_training_loop(tmp_path) -> None:
    """Periodic saves against a throttled durable tier: background
    mirroring, fast-tier eviction, a mid-run mirror restart, and a final
    restore_latest served by the durable tier alone."""
    fast, durable, root = _tiers(tmp_path)
    rng = np.random.default_rng(0)
    with mock.patch(_MIRROR_PLUGINS, side_effect=_mirror_factory(durable, _slow_fs(0.05))):
        mgr = CheckpointManager(root, keep_last_n=4, keep_fast_last_n=2)
        arrs = {}
        for step in range(1, 6):
            arrs[step] = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
            mgr.save(step, _app({"w": arrs[step]}))
            if step == 3:
                reset_mirror()  # a mid-run process bounce
                mgr.resume_mirrors()
        for step in mgr.all_steps():
            mgr.wait_durable(step, timeout=120)
        assert get_mirror().drain(timeout=120)
    shutil.rmtree(fast)
    mgr2 = CheckpointManager(root, keep_last_n=4, keep_fast_last_n=2)
    dst = _zeros({"w": arrs[5]})
    assert mgr2.restore_latest(dst) == 5
    _assert_equal(dst, {"w": arrs[5]})
    for step in mgr2.all_steps():
        assert verify_snapshot(mgr2.step_path(step), deep=True, tier="durable").ok


# ---------------------------------------------------------------------------
# wait_durable's default deadline
# ---------------------------------------------------------------------------


def test_wait_durable_default_timeout_is_knob_bounded(tmp_path, monkeypatch) -> None:
    """timeout=None resolves to TORCHSNAPSHOT_TPU_WAIT_DURABLE_TIMEOUT_SECONDS
    and surfaces a TimeoutError when durability never arrives."""
    from torchsnapshot_tpu_torch.tiered import mirror as mirror_mod

    _, _, url = _tiers(tmp_path)

    class _SettledJob:
        def __init__(self):
            self.done_evt = threading.Event()
            self.done_evt.set()
            self.error = None

    class _StubMirror:
        def jobs_for(self, fast_url):
            return [_SettledJob()]

        def metrics(self):
            return {}

    monkeypatch.setattr(mirror_mod, "is_durable", lambda p: False)
    monkeypatch.setattr(mirror_mod, "get_mirror", lambda: _StubMirror())
    with knobs.override_wait_durable_timeout_seconds(0.3):
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="not durable within"):
            mirror_mod.wait_durable(url, timeout=None)
        assert time.monotonic() - t0 < 10.0


def test_manager_wait_durable_default_deadline_is_knob_bounded(tmp_path) -> None:
    """A durable index that never names the step times out at the knob's
    deadline with an error naming the step."""
    fast, durable, root = _tiers(tmp_path)
    mgr = CheckpointManager(root, keep_last_n=3)
    mgr.save(1, _app({"w": torch.arange(16, dtype=torch.float32)}))
    mgr.wait_durable(1, timeout=60)
    os.remove(os.path.join(durable, ".manager_index"))
    os.remove(os.path.join(durable, ".manager_index.backup"))
    with knobs.override_wait_durable_timeout_seconds(0.4):
        with pytest.raises(TimeoutError, match="does not name it"):
            mgr.wait_durable(1)


def test_manager_wait_durable_lets_the_roots_mirror_jobs_settle(tmp_path, monkeypatch) -> None:
    """A root mirror job settles its telemetry into the fast root after the
    index reached the durable tier: ``wait_durable`` returns only once it
    has, so that the fast tier can be deleted at once."""
    fast, durable, root = _tiers(tmp_path)
    settle = Mirror._settle_telemetry

    def slow_settle(job, elapsed):
        if job.fast_url == fast:
            time.sleep(0.3)
        settle(job, elapsed)

    monkeypatch.setattr(Mirror, "_settle_telemetry", staticmethod(slow_settle))
    mgr = CheckpointManager(root, keep_last_n=3)
    mgr.save(1, _app(_w(1.0)))
    mgr.wait_durable(1, timeout=60)
    jobs = get_mirror().jobs_for(fast)
    assert jobs and all(j.done_evt.is_set() for j in jobs)
    shutil.rmtree(fast)
    dst = _zeros(_w(0.0))
    assert CheckpointManager(root, keep_last_n=3).restore_latest(dst) == 1
    _assert_equal(dst, _w(1.0))


# ---------------------------------------------------------------------------
# the two packages on one tiered root
# ---------------------------------------------------------------------------


def _jax_mirror():
    from torchsnapshot_tpu.tiered import mirror as jax_mirror

    return jax_mirror


@pytest.fixture
def jax_fresh_mirror():
    jm = _jax_mirror()
    jm.reset_mirror()
    yield jm
    jm.reset_mirror()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_durable_tree_restores_and_fscks_across_packages_after_fast_loss(tmp_path, writer, jax_fresh_mirror) -> None:
    """One package's manager saves and mirrors; the fast tier is lost
    entirely; the other package's manager restores the newest step from
    the durable tier alone, bit for bit, and its fsck passes the durable
    tree deep."""
    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.fsck import verify_snapshot as jax_verify

    fast, durable, root = _tiers(tmp_path)
    leaves = _leaves(n_leaves=3, size=1024, seed=7)
    if writer == "port":
        mgr = CheckpointManager(root, keep_last_n=2)
        for step in (1, 2):
            mgr.save(step, _app({k: torch.from_numpy(v) + step for k, v in leaves.items()}))
            mgr.wait_durable(step, timeout=60)
        assert get_mirror().drain(timeout=60)
    else:
        mgr = jts.CheckpointManager(root, keep_last_n=2)
        for step in (1, 2):
            mgr.save(step, {"m": jts.PyTreeState({k: v + step for k, v in leaves.items()})})
            mgr.wait_durable(step, timeout=60)
        assert jax_fresh_mirror.get_mirror().drain(timeout=60)
    shutil.rmtree(fast)
    want = {k: v + 2 for k, v in leaves.items()}
    if writer == "port":
        reader = jts.CheckpointManager(root, keep_last_n=2)
        dst = {"m": jts.PyTreeState({k: np.zeros_like(v) for k, v in want.items()})}
        assert reader.restore_latest(dst) == 2
        for k, v in want.items():
            np.testing.assert_array_equal(dst["m"].tree[k], v)
        report = jax_verify(reader.step_path(2), deep=True, tier="durable")
    else:
        reader = CheckpointManager(root, keep_last_n=2)
        dst = _zeros({k: torch.from_numpy(v) for k, v in want.items()})
        assert reader.restore_latest(dst) == 2
        _assert_equal(dst, {k: torch.from_numpy(v) for k, v in want.items()})
        report = verify_snapshot(reader.step_path(2), deep=True, tier="durable")
    assert report.ok and report.crcs_verified > 0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mirror_resumes_the_other_packages_journal(tmp_path, writer, jax_fresh_mirror) -> None:
    """One package's mirror dies after two durable writes and leaves its
    journal; the other package's mirror resumes it, ships exactly the
    blobs the journal lacks (the commit marker last), and the step is
    durable and deep-clean under both fscks."""
    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.fsck import verify_snapshot as jax_verify
    from torchsnapshot_tpu.storage_plugins.fs import FSStoragePlugin as JaxFS
    from torchsnapshot_tpu.test_utils import faulty_fs_plugin as jax_faulty

    fast, durable, url = _tiers(tmp_path)
    leaves = _leaves(n_leaves=6, size=1024, seed=3)
    jax_mirror = jax_fresh_mirror
    with knobs.override_mirror_progress_window_seconds(0.2):
        if writer == "port":
            faulty = faulty_fs_plugin(_fail_after(2), ops=("write",), exc_msg="durable outage")
            with mock.patch(_MIRROR_PLUGINS, side_effect=_mirror_factory(durable, faulty)):
                Snapshot.take(url, _app({k: torch.from_numpy(v) for k, v in leaves.items()}))
                (job,) = get_mirror().jobs_for(fast)
                assert job.wait(60) and job.error is not None
        else:
            faulty = jax_faulty(_fail_after(2), ops=("write",), exc_msg="durable outage")
            with mock.patch(
                "torchsnapshot_tpu.tiered.mirror.url_to_storage_plugin",
                side_effect=_mirror_factory(durable, faulty),
            ):
                jts.Snapshot.take(url, {"m": jts.PyTreeState(dict(leaves))})
                (job,) = jax_mirror.get_mirror().jobs_for(fast)
                assert job.wait(60) and job.error is not None
    doc = json.loads((tmp_path / "fast" / JOURNAL_BLOB).read_text())
    done_before = set(doc["done"])
    assert done_before and not doc["durable_committed"]
    lacking = set(doc["blobs"]) - done_before
    shipped: list = []
    if writer == "port":  # the JAX package's mirror resumes the port's journal

        class _RecordingJax(JaxFS):
            async def write(self, write_io):
                shipped.append(write_io.path)
                await super().write(write_io)

        restarted = jax_mirror.Mirror()
        target = "torchsnapshot_tpu.tiered.mirror.url_to_storage_plugin"
        from torchsnapshot_tpu.storage_plugin import url_to_storage_plugin as jax_url_to_plugin

        def factory(u):
            return _RecordingJax(root=u) if u.startswith(durable) else jax_url_to_plugin(u)
    else:
        restarted = Mirror()
        target = _MIRROR_PLUGINS
        factory = _mirror_factory(durable, _recording_fs(shipped))
    try:
        with mock.patch(target, side_effect=factory):
            job = restarted.resume(url)
            assert job is not None and job.wait(60) and job.error is None
    finally:
        restarted.stop()
    assert sorted(shipped) == sorted(lacking)
    assert shipped[-1] == ".snapshot_metadata"
    assert is_durable(url)
    assert verify_snapshot(url, deep=True, tier="durable").ok
    assert jax_verify(url, deep=True, tier="durable").ok
    after = json.loads((tmp_path / "fast" / JOURNAL_BLOB).read_text())
    assert after["durable_committed"] is True and sorted(after["done"]) == sorted(after["blobs"])


def test_journal_json_is_the_jax_packages_document() -> None:
    """Byte for byte both ways: the same journal state serializes to the
    same JSON, and each loader reads the other's done list and flag."""
    from torchsnapshot_tpu.tiered.journal import MirrorJournal as JaxJournal

    port = MirrorJournal(blobs={"0/m/w": 4096, ".snapshot_metadata": 900}, metadata=".snapshot_metadata")
    port.done.add("0/m/w")
    jax = JaxJournal(blobs={"0/m/w": 4096, ".snapshot_metadata": 900}, metadata=".snapshot_metadata")
    jax.done.add("0/m/w")
    assert port.to_json() == jax.to_json()
    port.durable_committed = True
    port.done.add(".snapshot_metadata")
    back = JaxJournal.from_json(port.to_json())
    assert back.done == port.done and back.durable_committed and back.complete
    again = MirrorJournal.from_json(back.to_json())
    assert again.to_json() == port.to_json() and again.complete
    assert MirrorJournal.from_json(jax.to_json()).pending() == []


def test_port_mirrored_root_has_no_ledger_or_mirror_trace(tmp_path) -> None:
    """Parity of the mirror's records (the name dates from before the
    port had a run ledger): with the ledger and the trace sink on, the
    port's mirrored root holds the record files a JAX manager's holds on
    the same schedule (the ledger with its ``mirror-settled`` event, the
    take's and the mirror job's traces on the fast tier) and none on the
    durable tier, and the two ledgers hold the same sequence of events."""
    import re

    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.telemetry import ledger as jax_ledger
    from torchsnapshot_tpu.tiered import mirror as jax_mirror
    from torchsnapshot_tpu_torch.telemetry import ledger as port_ledger

    def records_of(tier):
        return sorted(
            re.sub(r"pid\d+", "pid", os.path.relpath(os.path.join(d, n), tier))
            for d, _, files in os.walk(tier)
            for n in files
            if "ledger" in n or "trace" in n
        )

    leaves = _leaves(n_leaves=2, size=64)
    seen = {}
    for pkg in ("jax", "port"):
        fast, durable, root = _tiers(tmp_path / pkg)
        jax_mirror.reset_mirror()
        reset_mirror()
        try:
            with knobs.enable_ledger(), knobs.enable_trace():
                if pkg == "jax":
                    mgr = jts.CheckpointManager(root, keep_last_n=2)
                    mgr.save(1, {"m": jts.PyTreeState(dict(leaves))})
                    mgr.wait_durable(1, timeout=60)
                    assert jax_mirror.get_mirror().drain(timeout=60)
                    events = jax_ledger.load_ledger(os.path.join(fast, ".ledger.jsonl"))
                else:
                    mgr = CheckpointManager(root, keep_last_n=2)
                    mgr.save(1, {"m": TensorTreeState({k: torch.from_numpy(v) for k, v in leaves.items()})})
                    mgr.wait_durable(1, timeout=60)
                    assert get_mirror().drain(timeout=60)
                    events = port_ledger.load_ledger(os.path.join(fast, ".ledger.jsonl"))
        finally:
            jax_mirror.reset_mirror()
            reset_mirror()
            jax_ledger.reset_owned_roots()
            port_ledger.reset_owned_roots()
        # One settle per mirror job: the step's, then the index's (no step).
        settled = [e for e in events if e["event"] == "mirror-settled"]
        assert [e.get("step") for e in settled] == [1, None], settled
        assert all(e["error"] is None for e in settled)
        seen[pkg] = (records_of(fast), records_of(durable), [e["event"] for e in events], settled[0])
    assert seen["port"][0] == seen["jax"][0]
    assert ".ledger.jsonl" in seen["port"][0]
    assert "step_0000000001/.trace-mirror-pid-rank0.json" in seen["port"][0]
    assert seen["port"][1] == seen["jax"][1] == []
    assert seen["port"][2] == seen["jax"][2]
    assert seen["port"][3]["nbytes"] == seen["jax"][3]["nbytes"] > 0
    assert seen["port"][3]["blobs"] == seen["jax"][3]["blobs"]
