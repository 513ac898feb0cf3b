"""The peer-RAM tier in the port (``tiered/peer.py``): the cache and its
budget, the transport, the push worker and its placement docs, the restore
ladder peer RAM -> fast -> durable with every degradation mode, ``fsck
--tier peer``, the manager's and the preemption saver's hooks.

Ports of the 19 cases of the JAX package's ``tests/test_peer_tier.py``,
its two chunk-pool cases of ``tests/test_cas.py``, the peer half of
``tests/test_knobs.py``'s knob test and the peer sweep of
``tests/test_dist_crash_sweep.py`` (a dead peer mid-push, mid-pull, and
between commit and drain). Where a JAX case reads its restore report or
its run ledger, the port's case reads the same numbers from
``Snapshot.restore_telemetry``: ``tier_split``, ``peer`` (the degradation
evidence the doctor's ``peer-tier-degraded`` rule reads, which the port's
doctor judges here too) and, for the acceptance harness, each rank's own
split instead of the ledger's world sum. Added here: a pulled blob is verified once, not again by the read
pipeline; ``bytes_fetched`` leaves peer bytes out; an ``async_restore``
reads through the ladder; a chunk-store step pushes its chunks once and
dedups the next step's; and the cross-package cases: each package's
server serves the other's client, each package's fsck reads the other's
placement docs alike, and a step one package takes with the tier on is
restored by the other from its own peer cache, bit for bit. The
``cuda_only`` cases restore CUDA leaves through the ladder.

The suite's conftest pins ``TORCHSNAPSHOT_TPU_PEER_TIER=0``; these tests
opt in, and their dead-peer cases shrink the transfer timeout to seconds.
The module imports no jax at its top: the spawned workers import it.
"""

import asyncio
import json
import os
import shutil
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, PreemptionSaver, Snapshot, TensorTreeState, knobs, telemetry
from torchsnapshot_tpu_torch.cas import chunk_location, digest_key
from torchsnapshot_tpu_torch.dist_store import InProcessStore, publish_endpoint
from torchsnapshot_tpu_torch.fsck import verify_snapshot
from torchsnapshot_tpu_torch.integrity import PAGE_SIZE, compute_checksum_entry
from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
from torchsnapshot_tpu_torch.scheduler import PeerCacheBudget
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.telemetry import names as metric_names
from torchsnapshot_tpu_torch.test_utils import multiprocess_test, patch_storage_plugin
from torchsnapshot_tpu_torch.tiered import peer

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Unit: budget, cache, transport
# ---------------------------------------------------------------------------


def test_peer_cache_budget_reserve_release_refuse() -> None:
    budget = PeerCacheBudget(100)
    assert budget.try_reserve(60)
    assert not budget.try_reserve(50)
    assert budget.try_reserve(40)
    assert budget.reserved_bytes() == 100
    assert budget.peak_reserved_bytes == 100
    budget.release(60)
    assert budget.reserved_bytes() == 40
    assert budget.try_reserve(50)


def test_peer_cache_lru_eviction_pins_newest_committed() -> None:
    cache = peer.PeerCache(budget=PeerCacheBudget(100), keep_last_n=2)
    entry = compute_checksum_entry(b"x" * 40)
    assert cache.put("s1", 1, "a", entry, b"x" * 40)[0]
    cache.commit("s1", 1)
    assert cache.put("s2", 2, "a", entry, b"x" * 40)[0]
    cache.commit("s2", 2)
    # A third step's put evicts the LRU (s1), never the pinned s2.
    assert cache.put("s3", 3, "a", entry, b"x" * 40)[0]
    assert cache.get("s1", "a") is None
    assert cache.get("s2", "a") is not None
    assert cache.get("s3", "a") is not None
    # A put that cannot fit after evicting everything unpinned is refused,
    # the cache intact.
    ok, reason = cache.put("s4", 4, "big", compute_checksum_entry(b"y" * 90), b"y" * 90)
    assert (ok, reason) == (False, "budget")
    assert cache.get("s2", "a") is not None


def test_peer_cache_empty_commit_does_not_steal_pin_or_evict() -> None:
    """A commit of a step whose pushes all were refused neither steals the
    pin from, nor retention-evicts, the last step that holds bytes."""
    cache = peer.PeerCache(budget=PeerCacheBudget(100), keep_last_n=1)
    entry = compute_checksum_entry(b"x" * 40)
    assert cache.put("s1", 1, "a", entry, b"x" * 40)[0]
    cache.commit("s1", 1)
    cache.commit("s2", 2)  # an empty step
    assert cache.stats()["pinned"] == "s1"
    assert cache.get("s1", "a") is not None
    # A blob larger than the whole budget is refused up front, with no
    # collateral eviction.
    ok, reason = cache.put("s3", 3, "huge", compute_checksum_entry(b"y" * 200), b"y" * 200)
    assert (ok, reason) == (False, "budget")
    assert cache.get("s1", "a") is not None


def test_peer_cache_keep_last_n_commit_eviction() -> None:
    cache = peer.PeerCache(budget=PeerCacheBudget(10**6), keep_last_n=1)
    entry = compute_checksum_entry(b"z")
    for i, key in enumerate(("s1", "s2", "s3")):
        assert cache.put(key, i, "a", entry, b"z")[0]
        cache.commit(key, i)
    assert cache.stats()["committed_steps"] == ["s3"]
    assert cache.get("s1", "a") is None and cache.get("s2", "a") is None


def _serve(cache, server_cls=peer._PeerServer):
    server = server_cls(("127.0.0.1", 0), cache)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _shut(server) -> None:
    server.shutdown()
    server.server_close()


def test_peer_transport_roundtrip_and_dead_endpoint() -> None:
    cache = peer.PeerCache(budget=PeerCacheBudget(10**6))
    server = _serve(cache)
    try:
        client = peer.PeerClient("127.0.0.1", server.server_address[1], timeout=5)
        entry = compute_checksum_entry(b"hello")
        assert client.ping() is True
        assert client.push("s", 0, "blob", entry, b"hello") == (True, "ok")
        client.commit("s", 0)
        assert sorted(client.list_step("s")) == ["blob"]
        got = client.pull("s", "blob")
        assert got is not None and bytes(got[1]) == b"hello"
        assert client.pull("s", "absent") is None
        assert client.pull("stale-step", "blob") is None
        assert client.evict("s") and client.list_step("s") == {}
        client.close()
    finally:
        _shut(server)
    # A dead endpoint fails fast (bounded by the timeout), never hangs.
    t0 = time.monotonic()
    dead = peer.PeerClient("127.0.0.1", 1, timeout=0.5)
    with pytest.raises(peer.PeerTransferError):
        dead.request(metric_names.RPC_PEER_PING)
    assert dead.ping() is False
    assert time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# In-process integration: the push hook, the restore ladder, degradation
# ---------------------------------------------------------------------------


class _FakeWorld:
    """This process as rank 0 of a two-rank world: the real replicator
    configured on an in-process store, and a standalone cache server as
    rank 1, the surviving peer that each scenario manipulates."""

    def __init__(self, budget_bytes: int = 1 << 30) -> None:
        self.store = InProcessStore()
        self.rep = peer.get_replicator()
        assert self.rep.configure(self.store, rank=0, world_size=2)
        self.rank1_cache = peer.PeerCache(budget=PeerCacheBudget(budget_bytes))
        self.rank1_server = _serve(self.rank1_cache)
        publish_endpoint(self.store, peer.PEER_SERVICE, 1, "127.0.0.1", self.rank1_server.server_address[1])

    def close(self) -> None:
        peer.reset_peer_tier()
        try:
            _shut(self.rank1_server)
        except OSError:
            pass


@pytest.fixture(autouse=True)
def _fresh_tier():
    peer.reset_peer_tier()
    yield
    peer.reset_peer_tier()


@pytest.fixture
def fake_world():
    with knobs.enable_peer_tier():
        world = _FakeWorld()
        try:
            yield world
        finally:
            world.close()


N = 50_000


def _want(n: int = N, shift: float = 0.0) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32) + shift


def _take(path: str, n: int = N) -> None:
    Snapshot.take(path, {"m": TensorTreeState({"w": _want(n)})})


def _restore_and_verify(path: str, n: int = N) -> dict:
    dest = {"m": TensorTreeState({"w": torch.zeros(n, dtype=torch.float32)})}
    snap = Snapshot(path)
    snap.restore(dest)
    assert torch.equal(dest["m"].tree["w"], _want(n))
    return snap.restore_telemetry


def _data_locations(path: str, rank: int = 0) -> list:
    with open(os.path.join(path, "checksums", str(rank))) as f:
        return sorted(json.load(f))


def _remove_data_blobs(path: str) -> int:
    locations = _data_locations(path)
    for loc in locations:
        os.remove(os.path.join(path, loc))
    return len(locations)


def test_take_pushes_and_restore_serves_from_peer(fake_world, tmp_path) -> None:
    path = str(tmp_path / "snap")
    _take(path)
    assert fake_world.rep.drain(timeout=60)
    assert fake_world.rank1_cache.stats()["blobs"] > 0
    assert not fake_world.rep.degraded
    assert os.path.exists(os.path.join(path, peer.placement_doc_path(0)))
    # Without the data blobs in storage only peer RAM can serve them: the
    # replacement-rank case in one process.
    assert _remove_data_blobs(path) > 0
    tele = _restore_and_verify(path)
    split = tele["tier_split"]
    assert split["peer"] / sum(split.values()) >= 0.95
    assert tele["peer"]["failures"] == 0
    assert tele["peer"]["fallthrough_bytes"] == 0
    assert not tele["peer"]["degraded"]  # the JAX doctor rule stays quiet
    assert tele["bytes_fetched"] == 0  # peer bytes are no storage read


def test_ranged_pull_slices_server_side_and_verifies() -> None:
    """A ranged read of a paged blob ships only its window (verified by
    the pages it covers); a window covering no whole page takes one
    verified whole-blob transfer; corrupt cached bytes are refused both
    ways."""
    data = (bytes(range(256)) * ((2 * PAGE_SIZE) // 256 + 1))[: 2 * PAGE_SIZE + 1024]
    entry = compute_checksum_entry(data)
    assert len(entry) >= 5  # paged
    cache = peer.PeerCache(budget=PeerCacheBudget(len(data) * 2))
    server = _serve(cache)
    try:
        endpoint = ("127.0.0.1", server.server_address[1])
        client = peer.PeerClient(*endpoint, timeout=10)
        assert client.push("s", 0, "blob", entry, data)[0]
        client.close()
        ctx = peer.PeerRestoreContext({"blob": (1, endpoint, entry)}, "s", timeout=10)
        pulled = telemetry.metrics().counters_snapshot().get(metric_names.PEER_PULL_BYTES_TOTAL, 0)
        assert ctx.pull("blob", (PAGE_SIZE, 2 * PAGE_SIZE)) == data[PAGE_SIZE : 2 * PAGE_SIZE]
        moved = telemetry.metrics().counters_snapshot()[metric_names.PEER_PULL_BYTES_TOTAL] - pulled
        assert moved == PAGE_SIZE  # only the window crossed the socket
        assert ctx.pull("blob", (10, 100)) == data[10:100]
        assert ctx.peer_failures == 0
        with cache._lock:
            cache._steps["s"].blobs["blob"] = (entry, b"\x00" * len(data))
        assert ctx.pull("blob", (PAGE_SIZE, 2 * PAGE_SIZE)) is None
        assert ctx.pull("blob", None) is None
        assert ctx.peer_failures >= 2
        ctx.close()
    finally:
        _shut(server)


def test_tiered_root_local_fast_short_circuits_peer(fake_world, tmp_path) -> None:
    """On a tiered root a blob still on the local fast tier is read there
    (no wire traffic, no degradation); once the fast copy is gone the
    same blob rides the peer tier and the durable tier serves no data."""
    from torchsnapshot_tpu_torch.tiered import reset_mirror, wait_durable

    fast, durable = str(tmp_path / "fast"), str(tmp_path / "durable")
    path = f"tiered://{fast}|{durable}"
    reset_mirror()
    try:
        _take(path)
        wait_durable(path, timeout=60)
        assert fake_world.rep.drain(timeout=60)
        assert fake_world.rank1_cache.stats()["blobs"] > 0
        # The placement doc lives on the fast tier only.
        assert os.path.exists(os.path.join(fast, peer.placement_doc_path(0)))
        assert not os.path.exists(os.path.join(durable, peer.placement_doc_path(0)))
        tele = _restore_and_verify(path)
        assert tele["tier_split"]["fast"] > 0 and tele["tier_split"]["peer"] == 0
        assert tele["peer"]["failures"] == 0 and tele["peer"]["fallthrough_bytes"] == 0
        for loc in _data_locations(fast):
            os.remove(os.path.join(fast, loc))
        tele = _restore_and_verify(path)
        assert tele["tier_split"]["peer"] > 0
        assert tele["tier_split"]["durable"] == 0
    finally:
        reset_mirror()


def test_checksum_mismatch_falls_through_to_storage(fake_world, tmp_path) -> None:
    path = str(tmp_path / "snap")
    _take(path)
    assert fake_world.rep.drain(timeout=60)
    # Corrupt every cached payload, keeping the recorded entries: the
    # pulls must refuse the bytes and fall through to intact storage.
    with fake_world.rank1_cache._lock:
        for slot in fake_world.rank1_cache._steps.values():
            slot.blobs = {p: (e, b"\x00" * len(d)) for p, (e, d) in slot.blobs.items()}
    tele = _restore_and_verify(path)
    assert tele["peer"]["failures"] > 0
    assert tele["tier_split"]["peer"] == 0
    assert tele["peer"]["fallthrough_bytes"] > 0
    # The evidence the JAX package's peer-tier-degraded rule cites.
    assert tele["peer"]["degraded"] and tele["tier_split"]["durable"] > 0


def test_stale_step_misses_and_restores_from_storage(fake_world, tmp_path) -> None:
    path = str(tmp_path / "snap")
    _take(path)
    assert fake_world.rep.drain(timeout=60)
    fake_world.rank1_cache.evict_step(peer.peer_step_key(path))
    tele = _restore_and_verify(path)
    # No peer holds the step: no ladder at all.
    assert "tier_split" not in tele and "peer" not in tele


def test_budget_overflow_refuses_push_and_degrades(tmp_path) -> None:
    with knobs.enable_peer_tier():
        world = _FakeWorld(budget_bytes=64)  # nothing fits
        try:
            path = str(tmp_path / "snap")
            failures = telemetry.metrics().counters_snapshot().get(metric_names.PEER_PUSH_FAILURES_TOTAL, 0)
            _take(path)
            assert world.rep.drain(timeout=60)
            assert world.rank1_cache.stats()["blobs"] == 0
            tele = _restore_and_verify(path)
            assert "tier_split" not in tele
            with open(os.path.join(path, peer.placement_doc_path(0))) as f:
                doc = json.load(f)
            assert doc["blobs_refused"] > 0
            assert telemetry.metrics().counters_snapshot()[metric_names.PEER_PUSH_FAILURES_TOTAL] > failures
            report = verify_snapshot(path, tier="peer")
            assert not report.ok
            assert any(p.kind in ("unmirrored", "missing") for p in report.problems)
        finally:
            world.close()


def test_dead_peer_mid_push_degrades_without_wedging(tmp_path) -> None:
    with knobs.override_peer_transfer_timeout_seconds(1.0), knobs.enable_peer_tier():
        world = _FakeWorld()
        try:
            _shut(world.rank1_server)  # dead before the push
            path = str(tmp_path / "snap")
            t0 = time.monotonic()
            _take(path)
            assert world.rep.drain(timeout=30)
            assert time.monotonic() - t0 < 30.0
            assert world.rep.degraded
            gauges = telemetry.metrics().collect()["gauges"]
            assert gauges[metric_names.PEER_TIER_DEGRADED_STATE] == 1
            tele = _restore_and_verify(path)
            assert "tier_split" not in tele  # the dead peer is skipped
        finally:
            world.close()


def test_dead_peer_at_restore_falls_through(fake_world, tmp_path) -> None:
    path = str(tmp_path / "snap")
    _take(path)
    assert fake_world.rep.drain(timeout=60)
    _shut(fake_world.rank1_server)
    with knobs.override_peer_transfer_timeout_seconds(1.0):
        t0 = time.monotonic()
        tele = _restore_and_verify(path)
        assert time.monotonic() - t0 < 30.0
    assert "tier_split" not in tele


def test_kill_switch_means_no_server_no_pushes(tmp_path) -> None:
    store = InProcessStore()
    with knobs.disable_peer_tier():
        assert not peer.maybe_configure(PGWrapper(None))  # one process is inert anyway
        assert not peer.maybe_configure((store, 0, 2))  # the switch wins over a world
        assert peer.maybe_drain() is True
        path = str(tmp_path / "snap")
        _take(path)
        tele = _restore_and_verify(path)
        assert "tier_split" not in tele
        assert not os.path.exists(os.path.join(path, peer.placement_doc_path(0)))
    assert store.try_get("__endpoint/peer-tier/0") is None


def test_fsck_tier_peer_reports_unplaced_blobs(fake_world, tmp_path) -> None:
    path = str(tmp_path / "snap")
    _take(path)
    assert fake_world.rep.drain(timeout=60)
    report = verify_snapshot(path, tier="peer")
    assert report.ok, [p.detail for p in report.problems]
    assert report.blobs_checked > 0
    os.remove(os.path.join(path, peer.placement_doc_path(0)))
    report = verify_snapshot(path, tier="peer")
    assert not report.ok
    assert any(p.kind == "missing" for p in report.problems)


def test_degradation_evidence_quiet_when_healthy() -> None:
    """The doctor's ``peer-tier-degraded`` rule stays quiet on takes, on
    reports without peer fields and on a healthy split, and fires once a
    fallthrough byte is recorded; the port holds the evidence it reads
    too: a context that served or missed nothing reports not degraded,
    and one failure or one fallthrough byte turns it on."""
    from torchsnapshot_tpu_torch.telemetry.doctor import diagnose_reports

    def degraded(report):
        return [v for v in diagnose_reports([report]) if v.rule == metric_names.RULE_PEER_TIER_DEGRADED]

    ctx = peer.PeerRestoreContext({}, "s", timeout=1)
    ctx.count("peer", 100)
    fields = ctx.pipeline_fields()
    assert fields["tier_split"] == {"peer": 100, "fast": 0, "durable": 0}
    assert fields["peer"] == {
        "eligible_blobs": 0, "served_blobs": 1, "failures": 0, "fallthrough_bytes": 0, "degraded": False,
    }
    assert not degraded({"kind": "restore", **fields})
    assert not degraded({"kind": "take", **fields})
    assert not degraded({"kind": "restore"})
    ctx.note_fallthrough(10)
    fields = ctx.pipeline_fields()
    assert fields["peer"]["degraded"]
    assert degraded({"kind": "restore", **fields})[0].evidence["fallthrough_bytes"] == 10


def test_preemption_close_flushes_peer_tier(fake_world, tmp_path) -> None:
    """``PreemptionSaver.close()`` flushes the peer tier before any
    registered drain hook runs."""
    path = str(tmp_path / "snap")
    order = []
    release = threading.Event()
    real_run_job = peer.PeerReplicator._run_job

    async def slow_run_job(self, job):
        await asyncio.get_running_loop().run_in_executor(None, release.wait, 30)
        order.append("peer")
        await real_run_job(self, job)

    with mock.patch.object(peer.PeerReplicator, "_run_job", slow_run_job):
        _take(path)
        saver = PreemptionSaver(signals=())
        try:
            saver.register_drain(lambda: order.append("custom"))
            threading.Timer(0.3, release.set).start()
            saver.close()
        finally:
            saver.uninstall()
    assert order == ["peer", "custom"]
    assert fake_world.rank1_cache.stats()["blobs"] > 0


def test_restore_setup_endpoint_resolve_is_one_round_trip() -> None:
    """The registry resolve of a restore's setup is one batched store
    round trip for the whole world, and skips unpublished and garbage
    entries."""

    class CountingStore(InProcessStore):
        def __init__(self):
            super().__init__()
            self.counts: dict = {}

        def multi_get(self, keys):
            self.counts["multi_get"] = self.counts.get("multi_get", 0) + 1
            return super().multi_get(keys)

        def try_get(self, key):
            self.counts["try_get"] = self.counts.get("try_get", 0) + 1
            return super().try_get(key)

    store = CountingStore()
    world = 32
    for rank in range(world):
        if rank != 9:  # never published
            publish_endpoint(store, peer.PEER_SERVICE, rank, "h", 7000 + rank)
    store.set(f"__endpoint/{peer.PEER_SERVICE}/5", b"garbage-no-port")
    rep = peer.PeerReplicator()
    rep._store = store
    endpoints = rep.resolve_endpoints(range(world))
    assert store.counts == {"multi_get": 1}
    assert set(endpoints) == set(range(world)) - {9, 5}
    assert endpoints[0] == ("h", 7000)


# ---------------------------------------------------------------------------
# Added in the port: verified once, async restores, chunk stores
# ---------------------------------------------------------------------------


def test_pulled_bytes_are_verified_once(fake_world, tmp_path) -> None:
    """The ladder verifies every pulled blob against the entry it was
    pushed with; the read pipeline, holding the same entry, does not
    verify those bytes again. A blob the peer lacks is verified by the
    pipeline as before."""
    import torchsnapshot_tpu_torch.scheduler as scheduler

    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": TensorTreeState({"w": _want(), "v": _want(PAGE_SIZE + 77, 1.0)})})
    assert fake_world.rep.drain(timeout=60)
    locations = _data_locations(path)
    assert len(locations) == 2
    # The peer loses one blob: it is read and verified from storage.
    with fake_world.rank1_cache._lock:
        fake_world.rank1_cache._steps[peer.peer_step_key(path)].blobs.pop(locations[0])
    calls = {"peer": [], "pipeline": []}
    real = scheduler.verify_checksum

    def counting(where):
        def verify(buf, entry, p):
            calls[where].append(p)
            return real(buf, entry, p)

        return verify

    dest = {"m": TensorTreeState({"w": torch.zeros(N), "v": torch.zeros(PAGE_SIZE + 77)})}
    with mock.patch.object(peer, "verify_checksum", counting("peer")), mock.patch.object(
        scheduler, "verify_checksum", counting("pipeline")
    ):
        snap = Snapshot(path)
        snap.restore(dest)
    assert torch.equal(dest["m"].tree["w"], _want()) and torch.equal(dest["m"].tree["v"], _want(PAGE_SIZE + 77, 1.0))
    assert calls["peer"] == [locations[1]]
    assert calls["pipeline"] == [locations[0]]
    assert snap.restore_telemetry["verified_by_plugin"] == 1
    assert snap.restore_telemetry["peer"]["eligible_blobs"] == 1
    assert snap.restore_telemetry["tier_split"]["durable"] >= 4 * N


def test_async_restore_reads_through_the_ladder(fake_world, tmp_path) -> None:
    path = str(tmp_path / "snap")
    _take(path)
    assert fake_world.rep.drain(timeout=60)
    _remove_data_blobs(path)
    dest = {"m": TensorTreeState({"w": torch.zeros(N)})}
    pending = Snapshot(path).async_restore(dest)
    pending.wait()
    assert torch.equal(dest["m"].tree["w"], _want())
    assert pending.restore_telemetry["tier_split"]["peer"] == N * 4
    assert pending.restore_telemetry["bytes_fetched"] == 0


def test_peer_cache_chunk_pool_refcounts() -> None:
    cache = peer.PeerCache(budget=PeerCacheBudget(1 << 20))
    data = b"c" * 1000
    entry = compute_checksum_entry(data)
    loc = chunk_location(digest_key(entry))
    assert cache.put("stepA", 1, loc, entry, data)[0]
    bytes_after_one = cache.stats()["bytes"]
    # A second step referencing the chunk adds no bytes.
    assert cache.reference_chunks("stepB", 2, [loc, "../chunks/cas-x"]) == [loc]
    assert cache.stats()["bytes"] == bytes_after_one
    assert loc in cache.inventory("stepB")
    # Served for any step key: the path names the content.
    assert cache.get("stepB", loc)[1] == data
    assert cache.get("stepC", loc)[1] == data
    # Dropping one referencing step keeps it; the last frees the bytes.
    assert cache.evict_step("stepA")
    assert cache.get("stepB", loc)[1] == data
    assert cache.stats()["bytes"] == bytes_after_one
    assert cache.evict_step("stepB")
    assert cache.get("stepB", loc) is None
    assert cache.stats()["bytes"] == 0


def test_peer_transport_refchunks_roundtrip() -> None:
    cache = peer.PeerCache(budget=PeerCacheBudget(1 << 20))
    server = _serve(cache)
    try:
        client = peer.PeerClient(*server.server_address, timeout=10.0)
        data = b"z" * 512
        entry = compute_checksum_entry(data)
        loc = chunk_location(digest_key(entry))
        assert client.push("s1", 1, loc, entry, data) == (True, "ok")
        client.commit("s1", 1)
        assert client.reference_chunks("s2", 2, [loc]) == [loc]
        assert client.reference_chunks("s2", 2, ["../chunks/cas-nope"]) == []
        got = client.pull("s2", loc)
        assert got is not None and bytes(got[1]) == data
        assert loc in client.list_step("s2")
        client.close()
    finally:
        _shut(server)


def test_cas_steps_push_chunks_once_and_dedup(fake_world, tmp_path) -> None:
    """On a chunk store a step's ``../chunks/<key>`` blobs push; the next
    step of the same bytes ships none (one refchunks RPC references them
    in the neighbour's pool), its placement doc claims them, and a
    restore without the chunks in storage comes from the pool."""
    root = str(tmp_path / "root")
    with knobs.enable_cas():
        mgr = CheckpointManager(root)
        mgr.save(0, {"m": TensorTreeState({"w": _want()})})
        assert fake_world.rep.drain(timeout=60)
        first = fake_world.rep.last_job()
        assert first.blobs_pushed > 0 and first.blobs_deduped == 0
        assert all(p.startswith("../chunks/") for p in first.pushed)
        pool = fake_world.rank1_cache.stats()["chunk_bytes"]
        mgr.save(1, {"m": TensorTreeState({"w": _want()})})
        assert fake_world.rep.drain(timeout=60)
        second = fake_world.rep.last_job()
        assert second.blobs_pushed == 0 and second.blobs_deduped == first.blobs_pushed
        assert second.bytes_deduped == first.bytes_pushed
        assert fake_world.rank1_cache.stats()["chunk_bytes"] == pool
        assert verify_snapshot(mgr.step_path(1), tier="peer").ok
        shutil.rmtree(os.path.join(root, "chunks"))
        dest = {"m": TensorTreeState({"w": torch.zeros(N)})}
        snap = Snapshot(mgr.step_path(1))
        snap.restore(dest)
    assert torch.equal(dest["m"].tree["w"], _want())
    assert snap.restore_telemetry["tier_split"]["peer"] == N * 4


def test_manager_keep_peer_last_n_and_gc_eviction(fake_world, tmp_path) -> None:
    """A manager over the fake world's store: each save's push lands in
    the neighbour's cache, ``keep_peer_last_n`` bounds it, a step that
    retention drops is evicted from every advertised cache, and GC
    removes the step's placement doc with it."""
    from torchsnapshot_tpu_torch.dist_store import ProcessGroup

    fake_world.rank1_cache.keep_last_n = None
    rank0_pg = ProcessGroup(store=fake_world.store, rank=0, world_size=2)
    # The manager's own collectives would wait for a second rank: drive
    # its configure on the two-rank group, then save as one process.
    assert peer.maybe_configure(rank0_pg, keep_last_n=1)
    assert peer.get_replicator().cache.keep_last_n == 1
    mgr = CheckpointManager(str(tmp_path / "root"), keep_last_n=1)
    mgr.save(0, {"m": TensorTreeState({"w": _want()})})
    assert fake_world.rep.drain(timeout=60)
    key0 = peer.peer_step_key(mgr.step_path(0))
    assert fake_world.rank1_cache.inventory(key0)
    mgr.save(1, {"m": TensorTreeState({"w": _want(shift=1.0)})})
    assert fake_world.rep.drain(timeout=60)
    step0 = mgr.step_path(0)
    assert mgr.all_steps() == [1]
    assert not os.path.exists(os.path.join(step0, ".snapshot_metadata"))
    assert not os.path.exists(os.path.join(step0, peer.placement_doc_path(0)))
    assert os.path.exists(os.path.join(mgr.step_path(1), peer.placement_doc_path(0)))
    deadline = time.monotonic() + 30
    while fake_world.rank1_cache.inventory(key0) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert fake_world.rank1_cache.inventory(key0) == {}
    assert fake_world.rank1_cache.inventory(peer.peer_step_key(mgr.step_path(1)))


def test_peer_tier_knobs() -> None:
    """The suite pins the tier off; the packaged default (no variable) is
    on, inert until a multi-rank group configures it. Ring offset, cache
    budget and transfer timeout resolve the variable, else the default."""
    assert not knobs.is_peer_tier_enabled()  # the conftest pin
    with knobs.enable_peer_tier():
        assert knobs.is_peer_tier_enabled()
    assert not knobs.is_peer_tier_enabled()
    prev = os.environ.pop("TORCHSNAPSHOT_TPU_PEER_TIER", None)
    try:
        assert knobs.is_peer_tier_enabled()
        with knobs.disable_peer_tier():
            assert not knobs.is_peer_tier_enabled()
    finally:
        if prev is not None:
            os.environ["TORCHSNAPSHOT_TPU_PEER_TIER"] = prev
    assert knobs.get_peer_ring_offset() == 1
    with knobs.override_peer_ring_offset(3):
        assert knobs.get_peer_ring_offset() == 3
    assert knobs.get_peer_ring_offset() == 1
    assert knobs.get_peer_cache_budget_bytes() == 1024 * 1024 * 1024
    with knobs.override_peer_cache_budget_bytes(1234):
        assert knobs.get_peer_cache_budget_bytes() == 1234
    assert knobs.get_peer_cache_budget_bytes() == 1024 * 1024 * 1024
    assert knobs.get_peer_transfer_timeout_seconds() == 30.0
    with knobs.override_peer_transfer_timeout_seconds(2.5):
        assert knobs.get_peer_transfer_timeout_seconds() == 2.5
    assert knobs.get_peer_transfer_timeout_seconds() == 30.0


# ---------------------------------------------------------------------------
# Two processes: the preemption-recovery acceptance harness, the sweep
# ---------------------------------------------------------------------------


def _is_data(path: str) -> bool:
    return not path.startswith((".", "checksums", "cas/"))


class _CountingFS(FSStoragePlugin):
    data_reads: list = []

    async def read(self, read_io):
        if _is_data(read_io.path):
            _CountingFS.data_reads.append(read_io.path)
        await super().read(read_io)

    async def read_with_checksum(self, read_io):
        if _is_data(read_io.path):
            _CountingFS.data_reads.append(read_io.path)
        return await super().read_with_checksum(read_io)


@multiprocess_test(nproc=2)
def test_preemption_recovery_served_from_peer_ram(pg) -> None:
    """After a simulated preemption of rank 1 its replacement restores
    with zero storage data reads and at least 95% of its bytes from the
    surviving peer's RAM (the JAX case reads the world's split from its
    run ledger; here each rank's ``restore_telemetry``); with both caches
    wiped the same restore completes from storage alone."""
    import contextlib

    os.environ["TORCHSNAPSHOT_TPU_PEER_TIER"] = "1"
    os.environ["TORCHSNAPSHOT_TPU_PEER_TRANSFER_TIMEOUT_SECONDS"] = "5"
    root = os.path.join(tempfile.gettempdir(), f"torch-peer-accept-{os.getppid()}")
    wrapper = PGWrapper(pg)
    if pg.rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    wrapper.barrier()
    n = 200_000
    want = torch.arange(n, dtype=torch.float32) + pg.rank
    mgr = CheckpointManager(root, pg=pg, keep_peer_last_n=1)
    mgr.save(0, {"m": TensorTreeState({"w": want.clone()})})
    assert peer.maybe_drain(timeout=60)
    wrapper.barrier()
    if pg.rank == 1:
        # The host died with its cache; the replacement re-announces under
        # the same rank id.
        peer.reset_peer_tier()
        assert peer.maybe_configure(wrapper)
    wrapper.barrier()
    _CountingFS.data_reads = []
    ctx = patch_storage_plugin(_CountingFS) if pg.rank == 1 else contextlib.nullcontext()
    dest = {"m": TensorTreeState({"w": torch.zeros(n)})}
    with ctx:
        assert mgr.restore_latest(dest) == 0
    assert torch.equal(dest["m"].tree["w"], want)
    tele = mgr.restore_telemetry
    if pg.rank == 1:
        assert not _CountingFS.data_reads, _CountingFS.data_reads
        split = tele["tier_split"]
        assert split["peer"] / sum(split.values()) >= 0.95, split
        assert split["peer"] == n * 4
        assert tele["peer"]["failures"] == 0
        assert tele["bytes_fetched"] == 0
    else:
        # Rank 0's blobs were in rank 1's lost cache: storage serves them.
        assert tele["tier_split"]["peer"] == 0 and tele["peer"]["fallthrough_bytes"] == 0
    wrapper.barrier()
    # A double preemption: both caches wiped; storage alone serves.
    peer.reset_peer_tier()
    assert peer.maybe_configure(wrapper)
    wrapper.barrier()
    snap = Snapshot(mgr.step_path(0), pg=pg)
    dest = {"m": TensorTreeState({"w": torch.zeros(n)})}
    snap.restore(dest)
    assert torch.equal(dest["m"].tree["w"], want)
    assert "tier_split" not in snap.restore_telemetry
    wrapper.barrier()
    peer.reset_peer_tier()
    if pg.rank == 0:
        shutil.rmtree(root, ignore_errors=True)


def _peer_case(pg, scenario: str) -> None:
    os.environ["TORCHSNAPSHOT_TPU_PEER_TIER"] = "1"
    os.environ["TORCHSNAPSHOT_TPU_PEER_TRANSFER_TIMEOUT_SECONDS"] = "1.5"
    root = os.path.join(tempfile.gettempdir(), f"torch-peer-sweep-{scenario}-{os.getppid()}")
    wrapper = PGWrapper(pg)
    if pg.rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    wrapper.barrier()
    # A fresh tier per scenario: the last one may have killed this
    # rank's server.
    peer.reset_peer_tier()
    n = 50_000
    want = torch.arange(n, dtype=torch.float32) + pg.rank
    mgr = CheckpointManager(root, pg=pg)
    assert peer.get_replicator().configured
    wrapper.barrier()
    if scenario == "dead-mid-push" and pg.rank == 1:
        # Rank 0's ring target dies before rank 0 pushes.
        peer.get_replicator().stop_server()
    wrapper.barrier()
    t0 = time.monotonic()
    mgr.save(0, {"m": TensorTreeState({"w": want.clone()})})
    if scenario == "dead-between-commit-and-drain" and pg.rank == 1:
        peer.get_replicator().stop_server()
    assert peer.maybe_drain(timeout=60), "peer drain wedged"
    assert time.monotonic() - t0 < 90.0, f"{scenario}: push path wedged"
    if scenario == "dead-mid-push" and pg.rank == 0:
        assert peer.get_replicator().degraded
    wrapper.barrier()
    if scenario == "dead-mid-pull" and pg.rank == 1:
        peer.get_replicator().stop_server()
    wrapper.barrier()
    snap = Snapshot(mgr.step_path(0), pg=pg)
    dest = {"m": TensorTreeState({"w": torch.zeros(n)})}
    t0 = time.monotonic()
    snap.restore(dest)
    assert time.monotonic() - t0 < 90.0, f"{scenario}: restore wedged"
    assert torch.equal(dest["m"].tree["w"], want)  # durable truth, whatever served
    tele = snap.restore_telemetry
    if "tier_split" in tele:
        assert sum(tele["tier_split"].values()) > 0
    if scenario == "dead-mid-pull" and pg.rank == 1:
        # Rank 1's server died, but its blobs live in rank 0's cache.
        assert tele["tier_split"]["peer"] == n * 4
    if scenario != "dead-mid-pull" and pg.rank == 0:
        # Rank 0's target died before its blobs landed: storage served.
        assert tele.get("tier_split", {}).get("peer", 0) == 0
    wrapper.barrier()
    peer.reset_peer_tier()
    if pg.rank == 0:
        shutil.rmtree(root, ignore_errors=True)


@multiprocess_test(nproc=2)
def test_peer_tier_crash_sweep(pg) -> None:
    for scenario in ("dead-mid-push", "dead-mid-pull", "dead-between-commit-and-drain"):
        _peer_case(pg, scenario)


@multiprocess_test(nproc=2)
def test_fanout_over_the_ladder_counts_peer_bytes_once(pg) -> None:
    """Fan-out on, both caches intact, a ``Shard(0)`` DTensor on a gloo
    CPU mesh of 2: the ladder wraps the plugin before
    fan-out is built (the JAX order), so an owner's fetch pulls from peer
    RAM. No rank reads a data blob from storage, no peer byte counts as a
    storage byte (``bytes_fetched`` 0), and the peer bytes across the ranks
    are each saved shard's bytes exactly once."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from torchsnapshot_tpu_torch.test_utils import init_torch_group

    os.environ["TORCHSNAPSHOT_TPU_PEER_TIER"] = "1"
    os.environ["TORCHSNAPSHOT_TPU_PEER_TRANSFER_TIMEOUT_SECONDS"] = "5"
    os.environ["TORCHSNAPSHOT_TPU_FANOUT_RESTORE"] = "1"
    wrapper = PGWrapper(pg)
    root = os.path.join(tempfile.gettempdir(), f"torch-peer-fanout-{os.getppid()}")
    if pg.rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    wrapper.barrier()
    init_torch_group(pg)
    try:
        mesh = init_device_mesh("cpu", (2,))
        full = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)

        def dtensor(x):
            shape, offset = compute_local_shape_and_global_offset(x.shape, mesh, [Shard(0)])
            local = x[offset[0] : offset[0] + shape[0]].clone()
            return DTensor.from_local(local, mesh, [Shard(0)], run_check=False, shape=x.shape, stride=x.stride())

        mgr = CheckpointManager(root, pg=pg)
        mgr.save(0, {"m": TensorTreeState({"w": dtensor(full)})})
        assert peer.maybe_drain(timeout=60)
        wrapper.barrier()
        _CountingFS.data_reads = []
        dest = {"m": TensorTreeState({"w": dtensor(torch.zeros_like(full))})}
        with patch_storage_plugin(_CountingFS):
            assert mgr.restore_latest(dest) == 0
        got = dest["m"].tree["w"].to_local()
        assert torch.equal(got, full[32 * pg.rank : 32 * (pg.rank + 1)])
        tele = mgr.restore_telemetry
        assert not _CountingFS.data_reads, _CountingFS.data_reads
        assert tele["bytes_fetched"] == 0, tele
        peer_bytes = wrapper.all_gather_object(tele["tier_split"]["peer"])
        assert sum(peer_bytes) == full.numel() * 4, (peer_bytes, tele)
        wrapper.barrier()
    finally:
        dist.destroy_process_group()
        peer.reset_peer_tier()
        if pg.rank == 0:
            shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------


def _drive_client(client_mod, endpoint) -> None:
    """push / commit / list / pull (whole and ranged) / refchunks / stats
    / evict through ``client_mod``'s client against a server at
    ``endpoint``."""
    data = (bytes(range(256)) * ((2 * PAGE_SIZE) // 256 + 1))[: 2 * PAGE_SIZE + 9]
    entry = compute_checksum_entry(data)
    chunk = b"q" * 300
    chunk_entry = compute_checksum_entry(chunk)
    loc = chunk_location(digest_key(chunk_entry))
    client = client_mod.PeerClient(*endpoint, timeout=10)
    try:
        assert client.ping() is True
        assert tuple(client.push("s1", 1, "0/m/w", entry, data)) == (True, "ok")
        assert tuple(client.push("s1", 1, loc, chunk_entry, chunk)) == (True, "ok")
        client.commit("s1", 1)
        inv = client.list_step("s1")
        assert sorted(inv) == sorted(["0/m/w", loc])
        assert list(inv["0/m/w"][:3]) == list(entry[:3])
        assert bytes(client.pull("s1", "0/m/w")[1]) == data
        assert bytes(client.pull("s1", "0/m/w", (PAGE_SIZE, 2 * PAGE_SIZE))[1]) == data[PAGE_SIZE : 2 * PAGE_SIZE]
        assert client.pull("s1", "absent") is None
        assert client.reference_chunks("s2", 2, [loc, "../chunks/cas-none"]) == [loc]
        assert bytes(client.pull("s2", loc)[1]) == chunk
        assert client.stats()["chunks"] == 1
        assert client.evict("s1") and client.list_step("s1") == {}
    finally:
        client.close()


def test_jax_server_serves_port_client_and_the_reverse() -> None:
    """The wire is the same: a JAX ``_PeerServer`` answers the port's
    ``PeerClient``, and the port's server answers the JAX client (the
    frames of both carry a trace header, which each server decodes)."""
    from torchsnapshot_tpu.scheduler import PeerCacheBudget as JaxBudget
    from torchsnapshot_tpu.tiered import peer as jax_peer

    server = _serve(jax_peer.PeerCache(budget=JaxBudget(1 << 26)), jax_peer._PeerServer)
    try:
        _drive_client(peer, server.server_address)
    finally:
        _shut(server)
    server = _serve(peer.PeerCache(budget=PeerCacheBudget(1 << 26)))
    try:
        _drive_client(jax_peer, server.server_address)
    finally:
        _shut(server)


class _CrossWorld:
    """Rank 0 is one package's replicator (the pusher) and rank 1 the
    other's (the cache that survives), each on a store of its own
    package; both stores name both endpoints (at 127.0.0.1: the host
    names the replicators advertise need not resolve here)."""

    def __init__(self, pusher, pusher_store, holder, holder_store) -> None:
        self.mods = (pusher, holder)
        reps = []
        for rank, (mod, store) in enumerate(zip(self.mods, (pusher_store, holder_store))):
            rep = mod.get_replicator()
            assert rep.configure(store, rank=rank, world_size=2)
            reps.append(rep)
        for mod, store in zip(self.mods, (pusher_store, holder_store)):
            for rank, rep in enumerate(reps):
                mod.publish_endpoint(store, peer.PEER_SERVICE, rank, "127.0.0.1", rep.port)

    def close(self) -> None:
        for mod in self.mods:
            mod.reset_peer_tier()


@pytest.mark.parametrize("taker", ["jax", "port"])
def test_step_taken_by_one_package_restores_from_the_others_cache(tmp_path, taker) -> None:
    """One package takes a step with the tier on, pushing into the other
    package's cache; with the data blobs gone from storage the other
    package restores the step from its own cache, bit for bit, and both
    packages' ``fsck --tier peer`` read the placement doc alike."""
    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu import knobs as jax_knobs
    from torchsnapshot_tpu import telemetry as jax_telemetry
    from torchsnapshot_tpu.dist_store import InProcessStore as JaxStore
    from torchsnapshot_tpu.fsck import verify_snapshot as jax_verify
    from torchsnapshot_tpu.tiered import peer as jax_peer

    path = str(tmp_path / "snap")
    want = np.arange(N, dtype=np.float32) * 0.5
    port_store, jax_store = InProcessStore(), JaxStore()
    with knobs.enable_peer_tier(), jax_knobs.enable_peer_tier():
        if taker == "jax":
            world = _CrossWorld(jax_peer, jax_store, peer, port_store)
        else:
            world = _CrossWorld(peer, port_store, jax_peer, jax_store)
        try:
            if taker == "jax":
                jts.Snapshot.take(path, {"m": jts.PyTreeState({"w": want.copy()})})
                assert jax_peer.get_replicator().drain(timeout=60)
            else:
                Snapshot.take(path, {"m": TensorTreeState({"w": torch.from_numpy(want.copy())})})
                assert peer.get_replicator().drain(timeout=60)
            holder_cache = world.mods[1].get_replicator().cache
            assert holder_cache.stats()["blobs"] == len(_data_locations(path))
            ours, theirs = verify_snapshot(path, tier="peer"), jax_verify(path, tier="peer")
            assert ours.ok and theirs.ok and ours.blobs_checked == theirs.blobs_checked > 0
            _remove_data_blobs(path)
            if taker == "jax":
                dest = {"m": TensorTreeState({"w": torch.zeros(N)})}
                snap = Snapshot(path)
                snap.restore(dest)
                assert torch.equal(dest["m"].tree["w"], torch.from_numpy(want))
                assert snap.restore_telemetry["tier_split"]["peer"] == N * 4
            else:
                dest = {"m": jts.PyTreeState({"w": np.zeros(N, dtype=np.float32)})}
                jts.Snapshot(path).restore(dest)
                np.testing.assert_array_equal(dest["m"].tree["w"], want)
                report = jax_telemetry.last_report("restore", path=path)
                assert report.tier_split["peer"] == N * 4
        finally:
            world.close()


def test_degraded_placement_doc_reads_alike_in_both_fscks(tmp_path) -> None:
    """A push the neighbour's budget refused: both packages' fsck report
    the same problems of the port's placement doc."""
    from torchsnapshot_tpu.fsck import verify_snapshot as jax_verify

    with knobs.enable_peer_tier():
        world = _FakeWorld(budget_bytes=64)
        try:
            path = str(tmp_path / "snap")
            _take(path)
            assert world.rep.drain(timeout=60)
        finally:
            world.close()
    ours, theirs = verify_snapshot(path, tier="peer"), jax_verify(path, tier="peer")
    assert not ours.ok
    assert [(p.location, p.kind, p.detail) for p in ours.problems] == [
        (p.location, p.kind, p.detail) for p in theirs.problems
    ]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda_only
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_cuda_leaves_restore_through_the_ladder(fake_world, tmp_path, mode) -> None:
    """CUDA leaves taken with the tier on and restored, without their
    blobs in storage, from peer RAM into CUDA tensors, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    want = {
        "w": torch.randn(1000, 257, generator=gen, device="cuda").to(torch.bfloat16),
        "b": torch.randn(4099, generator=gen, device="cuda"),
    }
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": TensorTreeState({k: v.clone() for k, v in want.items()})})
    assert fake_world.rep.drain(timeout=60)
    _remove_data_blobs(path)
    dest = {"m": TensorTreeState({k: torch.zeros_like(v) for k, v in want.items()})}
    if mode == "sync":
        snap = Snapshot(path)
        snap.restore(dest)
        tele = snap.restore_telemetry
    else:
        pending = Snapshot(path).async_restore(dest)
        pending.wait()
        tele = pending.restore_telemetry
    for k, v in want.items():
        got = dest["m"].tree[k]
        assert got.is_cuda and torch.equal(got.view(torch.uint8), v.view(torch.uint8))
    assert tele["tier_split"]["peer"] == sum(v.numel() * v.element_size() for v in want.values())
