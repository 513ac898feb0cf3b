"""Checkpoint CDN of the port (``torchsnapshot_tpu_torch/cdn/``): the topic
codec, publisher ordering, the subscriber's diff / owner election / pull
tiers, the hot swap (numpy, CPU tensors, bfloat16, a world-1 ``DTensor``,
and CUDA leaves on a card), the manager's publish hook, and the chunk-store
leases that keep fleet-held chunks out of the training job's GC.

The ports of ``tests/test_cdn.py``'s 26 cases, its two jax-array swap
cases as torch-tensor cases. This file imports neither jax nor the JAX
package (the cases across the two packages are in
``test_torch_cdn_crosspkg.py``), so its ``cuda_only`` case runs on a
machine with a card and no jax: ``python -m pytest --noconftest -m
cuda_only tests/test_torch_cdn.py``.
"""

import os
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, TensorTreeState, knobs
from torchsnapshot_tpu_torch.cas import CASStore, digest_key
from torchsnapshot_tpu_torch.cdn import (
    Announce,
    CdnPublisher,
    CdnSubscriber,
    CdnSyncError,
    SwapError,
    WeightSwapper,
    announce_key,
    concat_assembler,
    durable_chunk_reader,
    head_key,
    manifest_digest,
    read_announce,
    read_head,
    verify_chunk_bytes,
)
from torchsnapshot_tpu_torch.dist_store import InProcessStore


def _chunk(seed: int, nbytes: int = 512):
    data = (seed.to_bytes(8, "little") * (nbytes // 8 + 1))[:nbytes]
    return digest_key(("crc32", zlib.crc32(data), len(data))), data


def _announce(seq=1, step=10, nchunks=3):
    chunks = {}
    blobs = {}
    for i in range(nchunks):
        key, data = _chunk(i)
        chunks[key] = len(data)
        blobs[key] = data
    return (
        Announce(
            topic="t", seq=seq, step=step, digest=manifest_digest(step, chunks),
            chunks=chunks, published_ts=time.time(),
        ),
        blobs,
    )


def _bytes_of(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(leaf).tobytes()


def _template_and_chunks(leaves):
    """Chunk blobs whose sorted-key concatenation is the sorted-leaf
    concatenation of ``leaves``."""
    payload = b"".join(_bytes_of(leaves[name]) for name in sorted(leaves))
    mid = len(payload) // 2
    chunks = {}
    for part in (payload[:mid], payload[mid:]):
        chunks[digest_key(("crc32", zlib.crc32(part), len(part)))] = part
    return chunks


def _one_chunk(leaves):
    """One chunk blob holding the sorted-leaf concatenation of ``leaves``
    (a single chunk: its order among keys cannot matter)."""
    payload = b"".join(_bytes_of(leaves[name]) for name in sorted(leaves))
    return {digest_key(("crc32", zlib.crc32(payload), len(payload))): payload}


def _bare_announce(chunks, step=1, seq=1):
    return Announce(
        topic="t", seq=seq, step=step, digest="",
        chunks={k: len(v) for k, v in chunks.items()}, published_ts=time.time(),
    )


# ---------------------------------------------------------------------------
# topic codec
# ---------------------------------------------------------------------------


def test_topic_keys_are_store_routable():
    assert head_key("t") == "__cdn/t/head"
    assert announce_key("t", 7) == "__cdn/t/announce/7"


def test_announce_round_trip():
    ann, _ = _announce()
    again = Announce.decode(ann.encode())
    assert again is not None
    assert again.seq == ann.seq and again.step == ann.step
    assert again.chunks == ann.chunks
    assert again.bytes_in_step == sum(ann.chunks.values())


def test_announce_decode_rejects_damage():
    ann, _ = _announce()
    raw = ann.encode()
    assert Announce.decode(b"not json") is None
    assert Announce.decode(b"{}") is None
    # A tampered field no longer matches the embedded digest.
    tampered = raw.replace(b'"step": 10', b'"step": 11')
    assert Announce.decode(tampered) is None


def test_announce_whose_chunks_are_not_a_mapping_decodes_to_none():
    """A damaged record is never a crash: a ``chunks`` field that is a
    JSON list decodes to None (the JAX decode raises ``AttributeError``
    there; ROADMAP queue 3)."""
    ann, _ = _announce()
    raw = ann.encode().replace(b'"chunks": {', b'"chunks": [{', 1).replace(b'}, "digest"', b'}], "digest"', 1)
    assert raw != ann.encode() and Announce.decode(raw) is None


def test_read_head_tolerates_missing_and_garbage():
    store = InProcessStore()
    assert read_head(store, "t") == 0
    store.set(head_key("t"), b"not-a-number")
    assert read_head(store, "t") == 0
    store.set(head_key("t"), b"3")
    assert read_head(store, "t") == 3


def test_verify_chunk_bytes():
    key, data = _chunk(1)
    assert verify_chunk_bytes(key, data)
    assert not verify_chunk_bytes(key, data[:-1])  # size mismatch
    flipped = bytes([data[0] ^ 1]) + data[1:]
    assert not verify_chunk_bytes(key, flipped)  # digest mismatch
    assert not verify_chunk_bytes("not-a-chunk", data)


# ---------------------------------------------------------------------------
# publisher
# ---------------------------------------------------------------------------


def test_publisher_bumps_head_and_announces():
    store = InProcessStore()
    pub = CdnPublisher(store, "t", publisher_id="trainer")
    key, data = _chunk(1)
    ann = pub.publish(100, {key: len(data)})
    assert ann is not None and ann.seq == 1
    assert read_head(store, "t") == 1
    got = read_announce(store, "t", 1)
    assert got is not None
    assert got.step == 100 and got.publisher == "trainer"
    ann2 = pub.publish(200, {key: len(data)})
    assert ann2.seq == 2 and read_head(store, "t") == 2


def test_publisher_resumes_seq_from_store():
    store = InProcessStore()
    key, data = _chunk(1)
    CdnPublisher(store, "t").publish(1, {key: len(data)})
    ann = CdnPublisher(store, "t").publish(2, {key: len(data)})
    assert ann.seq == 2


def test_publisher_reaps_announces_past_retention():
    """A long-running topic holds a bounded number of announce records;
    the head's announce always survives, also across a restart."""
    from torchsnapshot_tpu_torch.cdn.publisher import _ANNOUNCE_RETAIN

    store = InProcessStore()
    pub = CdnPublisher(store, "t")
    key, data = _chunk(1)
    total = _ANNOUNCE_RETAIN + 5
    for step in range(1, total + 1):
        assert pub.publish(step, {key: len(data)}) is not None
    live = [seq for seq in range(1, total + 1) if read_announce(store, "t", seq) is not None]
    assert live == list(range(total - _ANNOUNCE_RETAIN + 1, total + 1))
    assert read_head(store, "t") == total
    pub2 = CdnPublisher(store, "t")
    assert pub2.publish(total + 1, {key: len(data)}).seq == total + 1
    assert read_announce(store, "t", total + 1 - _ANNOUNCE_RETAIN) is None


# ---------------------------------------------------------------------------
# subscriber
# ---------------------------------------------------------------------------


def test_subscriber_syncs_only_novel_chunks():
    store = InProcessStore()
    pub = CdnPublisher(store, "t")
    reads = []

    def durable_fetch(key):
        reads.append(key)
        return blobs[key]

    ann, blobs = _announce(nchunks=3)
    sub = CdnSubscriber(store, "t", 0, 1, durable_fetch=durable_fetch)
    try:
        pub.publish(ann.step, ann.chunks)
        got = sub.track_once()
        assert got is not None and sub.applied_seq == 1
        assert sorted(reads) == sorted(ann.chunks)
        assert sub.stats.chunks_from_durable == 3

        # A rolling update: one churned chunk, two kept; only the novel
        # one is fetched, the rest come from the held pool.
        new_key, new_data = _chunk(99)
        blobs[new_key] = new_data
        kept = dict(ann.chunks)
        kept.pop(sorted(kept)[0])
        kept[new_key] = len(new_data)
        reads.clear()
        pub.publish(ann.step + 1, kept)
        assert sub.track_once(timeout=5.0) is not None
        assert reads == [new_key]
        assert sub.stats.chunks_held == 2
    finally:
        sub.close()


def test_subscriber_fleet_amplification_and_tiers():
    """3 subscribers, 3 chunks: each chunk leaves durable storage once (its
    elected owner); everyone else pulls from a peer."""
    store = InProcessStore()
    ann, blobs = _announce(nchunks=3)
    lock = threading.Lock()
    reads = []

    def durable_fetch(key):
        with lock:
            reads.append(key)
        return blobs[key]

    with knobs.override_cdn_pull_timeout_seconds(10):
        subs = [CdnSubscriber(store, "t", i, 3, durable_fetch=durable_fetch) for i in range(3)]
        try:
            CdnPublisher(store, "t").publish(ann.step, ann.chunks)
            threads = [threading.Thread(target=s.track_once, kwargs={"timeout": 10.0}) for s in subs]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30.0)
            assert not any(t.is_alive() for t in threads)
            assert all(s.applied_seq == 1 for s in subs)
            assert sorted(reads) == sorted(ann.chunks)
            assert sum(s.stats.chunks_from_peer for s in subs) == 6
            assert sum(s.stats.peer_fallbacks for s in subs) == 0
            for s in subs:
                assert s.stats.staleness_s and s.stats.staleness_s[0] >= 0.0
        finally:
            for s in subs:
                s.close()


def test_subscriber_falls_back_to_durable_on_dead_owner():
    """fleet_size=2 but rank 1 never exists: pulls aimed at it time out and
    fall back to durable reads, never a stall."""
    store = InProcessStore()
    ann, blobs = _announce(nchunks=2)
    with knobs.override_cdn_pull_timeout_seconds(0.2):
        sub = CdnSubscriber(store, "t", 0, 2, durable_fetch=blobs.__getitem__)
        try:
            CdnPublisher(store, "t").publish(ann.step, ann.chunks)
            assert sub.track_once(timeout=5.0) is not None
            assert sub.stats.chunks_from_durable == 2
            assert sub.stats.peer_fallbacks >= 1
        finally:
            sub.close()


def test_subscriber_without_durable_fetch_raises():
    store = InProcessStore()
    ann, _ = _announce(nchunks=1)
    with knobs.override_cdn_pull_timeout_seconds(0.1):
        sub = CdnSubscriber(store, "t", 0, 1)
        try:
            CdnPublisher(store, "t").publish(ann.step, ann.chunks)
            with pytest.raises(CdnSyncError):
                sub.track_once(timeout=5.0)
            assert sub.applied_seq == 0  # nothing half-applied
        finally:
            sub.close()


def test_wait_for_update_times_out_quietly():
    store = InProcessStore()
    sub = CdnSubscriber(store, "t", 0, 1)
    try:
        assert sub.wait_for_update(timeout=0.05) is None
    finally:
        sub.close()


# ---------------------------------------------------------------------------
# swap
# ---------------------------------------------------------------------------


def test_concat_assembler_reshapes_leaves():
    leaves = {
        "a": np.arange(6, dtype=np.float32).reshape(2, 3),
        "b": np.arange(4, dtype=np.int32),
    }
    chunks = _template_and_chunks(leaves)
    out = concat_assembler(leaves)(_bare_announce(chunks), chunks)
    np.testing.assert_array_equal(out["a"], leaves["a"])
    np.testing.assert_array_equal(out["b"], leaves["b"])


def test_concat_assembler_takes_torch_templates_bfloat16_included():
    """Torch templates (bfloat16, which numpy lacks, a bool and an empty
    leaf) come back as CPU tensors of their dtypes, byte for byte; the
    sizes are checked exactly both ways."""
    g = torch.Generator().manual_seed(0)
    leaves = {
        "a": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "b": torch.arange(7, dtype=torch.int64),
        "c": torch.tensor([True, False, True]),
        "d": torch.empty(0, 4, dtype=torch.bfloat16),
    }
    chunks = _one_chunk(leaves)
    assemble = concat_assembler(leaves)
    out = assemble(_bare_announce(chunks), chunks)
    for name, want in leaves.items():
        got = out[name]
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype and got.shape == want.shape
        assert _bytes_of(got) == _bytes_of(want)
    key = sorted(chunks)[-1]
    short = dict(chunks, **{key: chunks[key][:-2]})
    with pytest.raises(SwapError, match="needs"):
        assemble(_bare_announce(short), short)
    long = dict(chunks, **{key: chunks[key] + b"xx"})
    with pytest.raises(SwapError, match="past the template"):
        assemble(_bare_announce(long), long)


def test_weight_swapper_hot_swap():
    weights = {"w": np.zeros(8, dtype=np.float32)}
    swapper = WeightSwapper(weights)
    fresh = {"w": np.arange(8, dtype=np.float32)}
    chunks = _template_and_chunks(fresh)
    staged = swapper.stage(_bare_announce(chunks, step=42), chunks)
    # Staging alone leaves the served weights as they were.
    np.testing.assert_array_equal(swapper.weights["w"], 0.0)
    swapper.swap(staged)
    np.testing.assert_array_equal(swapper.weights["w"], fresh["w"])
    assert swapper.swapped_step == 42


def test_weight_swapper_swaps_torch_tensors_and_drops_the_old():
    """A torch leaf on the CPU is placed on the CPU (the device it asked
    for) as a new tensor; the swapper drops its reference to the old one,
    which the caller's last reference then frees."""
    import weakref

    weights = {"w": torch.zeros(16, dtype=torch.float32)}
    swapper = WeightSwapper(weights)
    fresh = {"w": torch.arange(16, dtype=torch.float32)}
    chunks = _one_chunk(fresh)
    old = weakref.ref(weights.pop("w"))
    swapper.swap(swapper.stage(_bare_announce(chunks, step=7), chunks))
    got = swapper.weights["w"]
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert torch.equal(got, fresh["w"])
    assert old() is None  # nothing holds the stale tensor any more


def test_weight_swapper_survives_successive_torch_swaps():
    """The default assembler reads the template's shapes once: later
    updates never touch the first weights."""
    swapper = WeightSwapper({"w": torch.zeros(16, dtype=torch.float32)})
    for seq, offset in enumerate([1.0, 2.0], start=1):
        chunks = _template_and_chunks({"w": np.arange(16, dtype=np.float32) + offset})
        swapper.swap(swapper.stage(_bare_announce(chunks, step=seq, seq=seq), chunks))
        expected = np.frombuffer(b"".join(chunks[k] for k in sorted(chunks)), np.float32)
        np.testing.assert_array_equal(swapper.weights["w"].numpy(), expected)
    assert swapper.swapped_step == 2


def test_weight_swapper_rejects_short_payload():
    swapper = WeightSwapper({"w": np.zeros(64, dtype=np.float32)})
    key, data = _chunk(1, nbytes=8)
    ann = Announce(topic="t", seq=1, step=1, digest="", chunks={key: len(data)}, published_ts=time.time())
    with pytest.raises(SwapError):
        swapper.stage(ann, {key: data})


def test_weight_swapper_refuses_mismatched_leaves_and_keeps_serving():
    """An assembler whose leaf differs from the served one in shape or
    dtype fails the stage; the served weights stay."""
    served = torch.ones(4, dtype=torch.bfloat16)
    swapper = WeightSwapper({"w": served}, assemble=lambda ann, cb: {"w": torch.zeros(4, dtype=torch.float32)})
    chunks = _one_chunk({"w": served})
    with pytest.raises(SwapError, match="served leaf"):
        swapper.stage(_bare_announce(chunks), chunks)
    assert swapper.weights["w"] is served and swapper.swapped_step is None


def test_weight_swapper_places_a_world_1_dtensor():
    """A ``DTensor`` leaf on a gloo mesh of one process is placed as its
    box under the old leaf's mesh and placements, bit for bit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    from torchsnapshot_tpu_torch.test_utils import get_free_port

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{get_free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        full = torch.zeros(6, 4, dtype=torch.bfloat16)
        old = DTensor.from_local(full.clone(), mesh, [Shard(0)], run_check=False, shape=full.shape, stride=full.stride())
        swapper = WeightSwapper({"w": old, "n": np.zeros(3, np.int32)})
        fresh = {
            "n": np.arange(3, dtype=np.int32),
            "w": torch.randn(6, 4, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16),
        }
        chunks = _one_chunk(fresh)
        swapper.swap(swapper.stage(_bare_announce(chunks, step=5), chunks))
        got = swapper.weights["w"]
        assert isinstance(got, DTensor) and got.device_mesh == mesh and tuple(got.placements) == (Shard(0),)
        assert got.shape == full.shape and _bytes_of(got.to_local()) == _bytes_of(fresh["w"])
        np.testing.assert_array_equal(swapper.weights["n"], fresh["n"])
        assert _bytes_of(old.to_local()) == _bytes_of(full)  # the old leaf was never written
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda_only
def test_weight_swapper_on_cuda_is_exact_frees_the_old_and_peaks_at_old_plus_new():
    """CUDA leaves: the swap places bit-identical tensors on the card
    through pinned memory and a side stream, frees the old storage once
    the serving stream is past it, and never holds more than old + new."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(11)
    shapes = {"a": (1024, 1024), "b": (4096,), "c": (333, 7)}
    old = {n: torch.randn(s, generator=g).to(torch.bfloat16).cuda() for n, s in shapes.items()}
    fresh = {n: torch.randn(s, generator=g).to(torch.bfloat16) for n, s in shapes.items()}
    set_bytes = sum(t.numel() * t.element_size() for t in fresh.values())
    chunks = _one_chunk(fresh)
    swapper = WeightSwapper(old)
    staged = swapper.stage(_bare_announce(chunks, step=3), chunks)
    assert all(t.is_pinned() for t in staged.host_arrays.values())
    old_ptrs = {n: t.data_ptr() for n, t in old.items()}
    del old
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    swapper.swap(staged)
    torch.cuda.current_stream().synchronize()
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_allocated()
    assert peak - before <= set_bytes * 1.05
    assert after <= before + set_bytes * 0.01
    for name, want in fresh.items():
        got = swapper.weights[name]
        assert got.is_cuda and got.data_ptr() != old_ptrs[name]
        assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))


# ---------------------------------------------------------------------------
# manager publish hook, and end to end through a real snapshot root
# ---------------------------------------------------------------------------


def _state(n=1024, offset=0.0):
    return {"m": TensorTreeState({"w": torch.arange(n, dtype=torch.float32) + offset})}


def test_manager_publishes_committed_steps(tmp_path):
    root = str(tmp_path / "ckpt")
    store = InProcessStore()
    with knobs.enable_cas(), knobs.enable_cdn():
        mgr = CheckpointManager(root, cdn_topic="run1", cdn_store=store)
        mgr.save(0, _state(offset=0.0))
        mgr.save(1, _state(offset=1.0))
    assert read_head(store, "run1") == 2
    ann = read_announce(store, "run1", 2)
    assert ann is not None and ann.step == 1
    fetch = durable_chunk_reader(root)
    for key in ann.chunks:
        assert verify_chunk_bytes(key, fetch(key))


def test_manager_hook_off_without_knob(tmp_path):
    store = InProcessStore()
    with knobs.enable_cas():  # the CDN knob stays pinned off
        mgr = CheckpointManager(str(tmp_path / "ckpt"), cdn_topic="run1", cdn_store=store)
        mgr.save(0, _state())
    assert read_head(store, "run1") == 0


def test_manager_without_cas_never_half_announces(tmp_path):
    """CAS off means no chunk refs: the manager skips the publish rather
    than announce an empty chunk set."""
    store = InProcessStore()
    with knobs.enable_cdn():
        mgr = CheckpointManager(str(tmp_path / "ckpt"), cdn_topic="run1", cdn_store=store)
        mgr.save(0, _state())
    assert read_head(store, "run1") == 0


def test_end_to_end_train_to_serve(tmp_path):
    """The trainer saves through the manager; a subscriber streams the
    chunks from the real root and swaps them into a same-shape template."""
    root = str(tmp_path / "ckpt")
    store = InProcessStore()
    with knobs.enable_cas(), knobs.enable_cdn():
        mgr = CheckpointManager(root, cdn_topic="run1", cdn_store=store)
        mgr.save(0, _state(offset=3.0))
    sub = CdnSubscriber(store, "run1", 0, 1, durable_fetch=durable_chunk_reader(root))
    try:
        ann = sub.wait_for_update(timeout=5.0)
        assert ann is not None
        chunk_bytes = sub.sync(ann)
        assert set(chunk_bytes) == set(ann.chunks)
        payload = b"".join(chunk_bytes[k] for k in sorted(chunk_bytes))
        got = np.frombuffer(payload, dtype=np.float32)
        np.testing.assert_array_equal(got, np.arange(1024, dtype=np.float32) + 3.0)
        swapper = WeightSwapper({"w": torch.zeros(1024, dtype=torch.float32)})
        swapper.swap(swapper.stage(ann, chunk_bytes))
        assert torch.equal(swapper.weights["w"], torch.arange(1024, dtype=torch.float32) + 3.0)
    finally:
        sub.close()


# ---------------------------------------------------------------------------
# chunk-store leases (the fleet's GC pin)
# ---------------------------------------------------------------------------


def test_lease_round_trip_and_live_union(tmp_path):
    store = CASStore(str(tmp_path / "ckpt"))
    store.pin(1, {"cas-a": 10})
    store.lease("cdn/t/0", {"cas-b": 20})
    pins, orphans, leases = store.load_full()
    assert sorted(pins) == [1]
    assert leases == {"cdn/t/0": {"cas-b": 20}}
    assert store.live_chunks(pins, leases) == {"cas-a", "cas-b"}
    # A re-lease replaces (drops cas-b, adds cas-c); unlease removes.
    store.lease("cdn/t/0", {"cas-c": 30})
    _, _, leases = store.load_full()
    assert leases == {"cdn/t/0": {"cas-c": 30}}
    store.unlease("cdn/t/0")
    _, _, leases = store.load_full()
    assert leases == {}
    pins, orphans = store.load()
    assert sorted(pins) == [1] and not orphans


def test_compact_preserves_outstanding_leases(tmp_path):
    store = CASStore(str(tmp_path / "ckpt"))
    store.pin(1, {"cas-a": 10})
    store.lease("cdn/t/0", {"cas-b": 20})
    pins, orphans = store.load()
    store.compact(pins, orphans)  # a lease-unaware caller
    _, _, leases = store.load_full()
    assert leases == {"cdn/t/0": {"cas-b": 20}}


def test_subscriber_leases_held_chunks(tmp_path):
    """A subscriber with a cas_store leases its held set after each apply
    and releases it on close."""
    cas_store = CASStore(str(tmp_path / "ckpt"))
    store = InProcessStore()
    ann, blobs = _announce(nchunks=2)
    sub = CdnSubscriber(store, "t", 0, 1, durable_fetch=blobs.__getitem__, cas_store=cas_store)
    try:
        CdnPublisher(store, "t").publish(ann.step, ann.chunks)
        assert sub.track_once(timeout=5.0) is not None
        _, _, leases = cas_store.load_full()
        assert leases == {sub.lease_id: dict(ann.chunks)}
    finally:
        sub.close()
    _, _, leases = cas_store.load_full()
    assert leases == {}


def test_manager_gc_spares_fleet_leased_chunks(tmp_path):
    """Retention drops a step whose unique chunk a subscriber still
    serves: the lease keeps the chunk file through GC, and once released
    the next GC pass reclaims it."""
    root = str(tmp_path / "ckpt")
    with knobs.enable_cas(), knobs.override_cas_gc_grace_seconds(0):
        mgr = CheckpointManager(root, keep_last_n=1)
        mgr.save(0, _state(offset=0.0))
        store = CASStore(root)
        pins, _, _ = store.load_full()
        step0_chunks = pins[0]
        store.lease("cdn/t/0", dict(step0_chunks))
        mgr.save(1, _state(offset=1.0))  # retention drops step 0
        chunks_dir = os.path.join(root, "chunks")
        for key in step0_chunks:
            assert os.path.exists(os.path.join(chunks_dir, key)), key
        store.unlease("cdn/t/0")
        mgr.save(2, _state(offset=2.0))
        live = store.live_chunks(store.load()[0])
        gone = [k for k in step0_chunks if k not in live]
        assert gone
        for key in gone:
            assert not os.path.exists(os.path.join(chunks_dir, key)), key
