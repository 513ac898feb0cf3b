"""The port's CDN under chaos: a publisher killed mid-announce, a
subscriber killed mid-swap, corrupted peer frames, and ``fsck --cas``
with fleet leases outstanding. The ports of ``tests/test_cdn_chaos.py``'s
5 cases. The invariants: subscribers converge to the last fully published
step, a torn announce is never swapped in, and a fleet-held chunk never
reads as store damage."""

import os
import zlib

import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, TensorTreeState, knobs
from torchsnapshot_tpu_torch.cas import CASStore, digest_key
from torchsnapshot_tpu_torch.cdn import CdnPublisher, CdnSubscriber, WeightSwapper, read_announce, read_head
from torchsnapshot_tpu_torch.chaos import (
    ChaosEngine,
    FaultPlan,
    SimulatedCrash,
    arm,
    declared_crashpoints,
    disarm,
    install_wire_chaos,
    uninstall_wire_chaos,
)
from torchsnapshot_tpu_torch.dist_store import InProcessStore
from torchsnapshot_tpu_torch.fsck import verify_cas_store
from torchsnapshot_tpu_torch.telemetry import names


def _chunk(seed: int, nbytes: int = 256):
    data = (seed.to_bytes(8, "little") * (nbytes // 8 + 1))[:nbytes]
    return digest_key(("crc32", zlib.crc32(data), len(data))), data


def _blobs(*seeds):
    out = {}
    for s in seeds:
        key, data = _chunk(s)
        out[key] = data
    return out


def test_cdn_crash_points_join_the_matrix():
    declared = declared_crashpoints()
    assert names.CRASH_CDN_PUBLISH_ANNOUNCED in declared
    assert names.CRASH_CDN_SWAP_STAGED in declared


def test_publisher_killed_mid_announce_leaves_head_unmoved():
    """The announce record lands before the head bump: a publisher killed
    between the two leaves an unobservable record. A restarted trainer
    publishes over it and the fleet converges to that step only."""
    store = InProcessStore()
    blobs = _blobs(1, 2)
    chunks = {k: len(v) for k, v in blobs.items()}

    pub = CdnPublisher(store, "t")
    arm(names.CRASH_CDN_PUBLISH_ANNOUNCED)
    try:
        with pytest.raises(SimulatedCrash):
            pub.publish(100, chunks)
    finally:
        disarm()
    assert read_head(store, "t") == 0
    sub = CdnSubscriber(store, "t", 0, 1, durable_fetch=blobs.__getitem__)
    try:
        assert sub.wait_for_update(timeout=0.1) is None
        pub2 = CdnPublisher(store, "t")
        ann = pub2.publish(101, chunks)
        assert ann is not None and ann.seq == 1
        got = sub.track_once(timeout=5.0)
        assert got is not None and got.step == 101
        assert sub.applied_seq == 1
    finally:
        sub.close()


def test_subscriber_killed_mid_swap_serves_previous_step():
    """The crash point sits between stage and swap: a subscriber killed
    there still serves the previous fully applied step (a CPU tensor
    here), and its next tracking cycle applies the update."""
    store = InProcessStore()
    blobs1 = _blobs(1)
    blobs2 = _blobs(2)
    blobs = dict(blobs1, **blobs2)
    payload1 = b"".join(blobs1[k] for k in sorted(blobs1))
    template = {"w": torch.zeros(len(payload1), dtype=torch.uint8)}

    pub = CdnPublisher(store, "t")
    sub = CdnSubscriber(store, "t", 0, 1, durable_fetch=blobs.__getitem__)
    swapper = WeightSwapper(template)
    try:
        pub.publish(1, {k: len(v) for k, v in blobs1.items()})
        assert sub.track_once(swapper, timeout=5.0) is not None
        assert sub.applied_seq == 1
        served_before = swapper.weights["w"].clone()

        pub.publish(2, {k: len(v) for k, v in blobs2.items()})
        arm(names.CRASH_CDN_SWAP_STAGED)
        try:
            with pytest.raises(SimulatedCrash):
                sub.track_once(swapper, timeout=5.0)
        finally:
            disarm()
        assert sub.applied_seq == 1
        assert swapper.swapped_step == 1
        assert torch.equal(swapper.weights["w"], served_before)

        assert sub.track_once(swapper, timeout=5.0) is not None
        assert sub.applied_seq == 2 and swapper.swapped_step == 2
        payload2 = b"".join(blobs2[k] for k in sorted(blobs2))
        assert swapper.weights["w"].numpy().tobytes() == payload2
    finally:
        sub.close()


def test_corrupt_peer_frames_never_poison_the_swap():
    """Wire chaos corrupts peer-transport frames: the digest check rejects
    the damaged bytes and the subscriber retries or falls back; the synced
    bytes are always the announced ones."""
    store = InProcessStore()
    blobs = _blobs(1, 2, 3)
    chunks = {k: len(v) for k, v in blobs.items()}
    with knobs.override_cdn_pull_timeout_seconds(1.0):
        # The owner (rank 1) syncs first, so that the victim's pulls have a
        # live peer; the first frames the victim receives are corrupted.
        subs = [CdnSubscriber(store, "t", i, 2, durable_fetch=blobs.__getitem__) for i in range(2)]
        try:
            CdnPublisher(store, "t").publish(5, chunks)
            assert subs[1].track_once(timeout=5.0) is not None
            engine = ChaosEngine(FaultPlan.single(point="wire-recv", mode="corrupt", times=3))
            install_wire_chaos(engine)
            try:
                assert subs[0].track_once(timeout=5.0) is not None
            finally:
                uninstall_wire_chaos()
            assert engine.fired  # the plan did inject
            assert subs[0].applied_seq == 1
            for key, data in subs[0].sync(read_announce(store, "t", 1)).items():
                assert data == blobs[key]
        finally:
            for s in subs:
                s.close()


def test_fsck_cas_clean_with_fleet_lease_outstanding(tmp_path):
    """Retention dropped a step the fleet still serves: the leased chunks
    survive GC as unreferenced entries (informational, never problems), so
    ``fsck --cas`` stays clean."""
    root = str(tmp_path / "ckpt")
    with knobs.enable_cas(), knobs.override_cas_gc_grace_seconds(0):
        mgr = CheckpointManager(root, keep_last_n=1)
        mgr.save(0, {"m": TensorTreeState({"w": torch.arange(512, dtype=torch.float32)})})
        store = CASStore(root)
        pins, _, _ = store.load_full()
        step0_chunks = dict(pins[0])
        store.lease("cdn/t/0", step0_chunks)
        mgr.save(1, {"m": TensorTreeState({"w": torch.arange(512, dtype=torch.float32) + 9.0})})
    report = verify_cas_store(root, deep=True)
    assert report.ok, [str(p) for p in report.problems]
    on_disk = set(os.listdir(os.path.join(root, "chunks")))
    for key in step0_chunks:
        # Leased and no longer referenced, or shared with the live step.
        assert key in report.unreferenced or key in on_disk
    assert any(key in report.unreferenced for key in step0_chunks)
