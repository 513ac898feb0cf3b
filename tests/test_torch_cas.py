"""The content-addressed chunk store in the port (``cas/``).

Port of the JAX package's ``tests/test_cas.py`` cases that need no tiered
mirror, peer tier, run ledger or doctor: digest keys, dedup'd take and
restore bit-identical to the legacy layout, refcounted GC (shared chunks
survive, dead ones are reclaimed, the grace window defers them), crash
healing (a torn journal tail, a lost journal or pin rebuilt from the
manifests), mixed legacy and CAS roots, incremental refs collapsing onto
chunks, the legacy orphaned-base guard, two-process dedup of identical
per-rank leaves, and the whole-store fsck. Added here: both packages on
one chunk store in both directions (identical keys for identical bytes,
snapshots restored bit for bit, each manager reconciling and collecting
the other's root, each fsck passing the other's), batched slabs as one
chunk each (with the pack's plain version on the CPU), a failing chunk
write, repair by quarantine, the write and dedup counters, and the
refusals that stay.

The module imports no jax at its top: the spawned workers import it.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, TensorTreeState, knobs, telemetry
from torchsnapshot_tpu_torch.cas import (
    CASStore,
    chunk_location,
    chunk_refs,
    digest_key,
    is_chunk_location,
    key_of_location,
    nbytes_of_key,
    parse_key,
)
from torchsnapshot_tpu_torch.integrity import PAGE_SIZE, ChecksumError, compute_checksum_entry
from torchsnapshot_tpu_torch.manager import referenced_steps
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.telemetry import names
from torchsnapshot_tpu_torch.test_utils import faulty_fs_plugin, patch_storage_plugin, run_multiprocess

torch.set_num_threads(1)

N = 4096


def _w(n: int = N, offset: float = 0.0) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32) + offset


def _state(n: int = N, offset: float = 0.0) -> dict:
    return {"m": TensorTreeState({"w": _w(n, offset), "frozen": torch.ones(n // 4)})}


def _jax_state(n: int = N, offset: float = 0.0) -> dict:
    """The same leaves as ``_state``, as the JAX package's numpy tree."""
    import torchsnapshot_tpu as jts

    return {
        "m": jts.PyTreeState(
            {"w": np.arange(n, dtype=np.float32) + offset, "frozen": np.ones(n // 4, np.float32)}
        )
    }


def _chunk_files(root) -> dict:
    cdir = os.path.join(root, "chunks")
    if not os.path.isdir(cdir):
        return {}
    return {n: os.path.getsize(os.path.join(cdir, n)) for n in os.listdir(cdir) if n.startswith("cas-")}


def _restored_w(path: str) -> torch.Tensor:
    dest = _state(offset=-1.0)
    Snapshot(path).restore(dest)
    return dest["m"].tree["w"]


@pytest.fixture
def cas_on():
    with knobs.enable_cas():
        yield


@pytest.fixture
def no_grace():
    with knobs.enable_cas(), knobs.override_cas_gc_grace_seconds(0):
        yield


# ---------------------------------------------------------------------------
# digest keys
# ---------------------------------------------------------------------------


def test_digest_key_derivation_and_parse() -> None:
    from torchsnapshot_tpu.cas import digest_key as jax_digest_key
    from torchsnapshot_tpu.integrity import compute_checksum_entry as jax_entry

    data = b"hello chunk store"
    entry = compute_checksum_entry(data)
    key = digest_key(entry)
    assert key == jax_digest_key(jax_entry(data))  # the same string in both packages
    assert key.startswith("cas-") and nbytes_of_key(key) == len(data)
    alg, nbytes, crc = parse_key(key)
    assert alg == entry[0] and nbytes == entry[2] and crc == entry[1]
    assert key == digest_key(compute_checksum_entry(data))
    assert key != digest_key(compute_checksum_entry(b"hello chunk steve"))
    loc = chunk_location(key)
    assert is_chunk_location(loc) and key_of_location(loc) == key
    assert not is_chunk_location("../step_0000000001/0/m/w")
    assert not is_chunk_location("0/m/w")
    assert key_of_location("../chunks/not-a-key") is None


def test_digest_key_paged_entries_fold_pages() -> None:
    from torchsnapshot_tpu.cas import digest_key as jax_digest_key
    from torchsnapshot_tpu.integrity import PAGE_SIZE as JAX_PAGE_SIZE
    from torchsnapshot_tpu.integrity import compute_checksum_entry as jax_entry

    assert PAGE_SIZE == JAX_PAGE_SIZE
    big = np.arange(PAGE_SIZE // 4 * 2 + 999, dtype=np.int32).tobytes()
    entry = compute_checksum_entry(big)
    assert len(entry) >= 5  # paged
    key = digest_key(entry)
    assert "-p" in key and nbytes_of_key(key) == len(big)
    assert parse_key(key)[2] == entry[1]
    assert key == jax_digest_key(jax_entry(big))


# ---------------------------------------------------------------------------
# take / restore round trip + dedup
# ---------------------------------------------------------------------------


def test_take_restore_roundtrip_bit_identical_to_legacy(tmp_path) -> None:
    legacy_root, cas_root = str(tmp_path / "legacy"), str(tmp_path / "cas")
    state = _state(offset=3.0)
    Snapshot.take(os.path.join(legacy_root, "step_0000000001"), state)
    with knobs.enable_cas():
        snap = Snapshot.take(os.path.join(cas_root, "step_0000000001"), state)
    locs = {p: e.location for p, e in snap.metadata.manifest.items() if getattr(e, "location", None)}
    assert locs and all(is_chunk_location(loc) for loc in locs.values())
    # The chunk's bytes are the legacy blob's: same serialization, another
    # address.
    with open(os.path.join(legacy_root, "step_0000000001", "0", "m", "w"), "rb") as f:
        legacy_w = f.read()
    with open(os.path.join(cas_root, "chunks", key_of_location(locs["0/m/w"])), "rb") as f:
        assert f.read() == legacy_w
    # Restore verifies through the rekeyed table: its keys are the chunk
    # read paths.
    table = json.load(open(os.path.join(cas_root, "step_0000000001", "checksums", "0")))
    assert set(table) == set(locs.values())
    assert torch.equal(_restored_w(os.path.join(cas_root, "step_0000000001")), state["m"].tree["w"])


def test_second_identical_take_stores_nothing_new(tmp_path, cas_on) -> None:
    root = str(tmp_path / "ckpt")
    state = _state()
    registry = telemetry.metrics()
    base = registry.counters_snapshot()
    Snapshot.take(os.path.join(root, "step_0000000001"), state)
    before = _chunk_files(root)
    mid = registry.counters_snapshot()
    Snapshot.take(os.path.join(root, "step_0000000002"), state)
    after = registry.counters_snapshot()
    assert _chunk_files(root) == before
    m1 = Snapshot(os.path.join(root, "step_0000000001")).metadata.manifest
    m2 = Snapshot(os.path.join(root, "step_0000000002")).metadata.manifest
    assert chunk_refs(m1) == chunk_refs(m2)
    nbytes = sum(before.values())

    def delta(a, b, name):
        return b.get(name, 0) - a.get(name, 0)

    assert delta(base, mid, names.CAS_BYTES_WRITTEN_TOTAL) == nbytes
    assert delta(mid, after, names.CAS_BYTES_WRITTEN_TOTAL) == 0
    assert delta(mid, after, names.CAS_BYTES_DEDUPED_TOTAL) == nbytes
    assert delta(mid, after, names.CAS_CHUNKS_DEDUPED_TOTAL) == 2


def test_restore_verifies_chunk_bytes(tmp_path, cas_on) -> None:
    root = str(tmp_path / "ckpt")
    snap = Snapshot.take(os.path.join(root, "step_0000000001"), _state())
    key = key_of_location(snap.metadata.manifest["0/m/w"].location)
    with open(os.path.join(root, "chunks", key), "r+b") as f:
        f.seek(16)
        f.write(b"\xde\xad")
    with pytest.raises(ChecksumError):
        Snapshot(os.path.join(root, "step_0000000001")).restore(_state())


def test_async_take_cas_roundtrip(tmp_path, cas_on) -> None:
    root = str(tmp_path / "ckpt")
    state = _state(offset=11.0)
    snap = Snapshot.async_take(os.path.join(root, "step_0000000001"), state).wait()
    assert all(
        is_chunk_location(e.location)
        for e in snap.metadata.manifest.values()
        if getattr(e, "location", None)
    )
    dest = _state()
    snap.restore(dest)
    assert torch.equal(dest["m"].tree["w"], state["m"].tree["w"])
    assert os.path.exists(os.path.join(root, "step_0000000001", "cas", "0"))


def test_ineligible_scheme_falls_back_to_legacy(cas_on) -> None:
    snap = Snapshot.take("memory://casless/step_0000000001", _state())
    assert not any(
        is_chunk_location(e.location)
        for e in snap.metadata.manifest.values()
        if getattr(e, "location", None)
    )


def test_failing_chunk_write_fails_the_take(tmp_path, cas_on) -> None:
    """No quiet fallback: a chunk write that fails fails the take, and no
    commit marker is left."""
    path = os.path.join(str(tmp_path / "ckpt"), "step_0000000001")
    faulty = faulty_fs_plugin(lambda p: p.startswith("../chunks/"), ops=("write",))
    with patch_storage_plugin(faulty), pytest.raises(OSError, match="injected"):
        Snapshot.take(path, _state())
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))


@pytest.mark.parametrize("pack", [False, True], ids=["per_member", "pack"])
def test_batched_slab_is_one_chunk(tmp_path, cas_on, pack) -> None:
    """A slab written under ``batched/`` becomes one chunk; its members
    keep their byte ranges within it and restore bit for bit (on the CPU
    the pack wrapper runs its plain version)."""
    root = str(tmp_path / "ckpt")
    leaves = {f"l{i}": torch.arange(100 + i, dtype=torch.float32) * (i + 1) for i in range(12)}
    with knobs.enable_batching(), (knobs.enable_device_pack() if pack else contextlib.nullcontext()):
        snap = Snapshot.take(os.path.join(root, "step_0000000001"), {"m": TensorTreeState(dict(leaves))})
    entries = [e for e in snap.metadata.manifest.values() if getattr(e, "location", None)]
    assert {e.location for e in entries} == {chunk_location(k) for k in _chunk_files(root)}
    assert len(_chunk_files(root)) == 1 and all(e.byte_range is not None for e in entries)
    dest = {"m": TensorTreeState({k: torch.zeros_like(v) for k, v in leaves.items()})}
    with knobs.enable_batching():
        Snapshot(os.path.join(root, "step_0000000001")).restore(dest)
    assert all(torch.equal(dest["m"].tree[k], v) for k, v in leaves.items())


# ---------------------------------------------------------------------------
# manager: refcounted GC
# ---------------------------------------------------------------------------


def test_manager_retention_refcount_gc(tmp_path, no_grace) -> None:
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, keep_last_n=2)
    for i in range(5):
        mgr.save(i, _state(offset=float(i)))
    # Two live 'w' variants (steps 3, 4) and one shared 'frozen' chunk.
    assert len(_chunk_files(root)) == 3
    dest = _state()
    assert mgr.restore_latest(dest) == 4
    assert torch.equal(dest["m"].tree["w"], _w(offset=4.0))
    pins, orphans = CASStore(root).load()
    assert sorted(pins) == [3, 4] and not orphans
    acct = mgr._last_cas_accounting
    assert acct["step"] == 4 and acct["chunks_new"] == 1 and acct["chunks_reused"] == 1
    assert acct["bytes_new"] == N * 4 and acct["bytes_total"] == N * 4 + N


def test_gc_grace_defers_then_reclaims(tmp_path, cas_on) -> None:
    root = str(tmp_path / "ckpt")
    with knobs.override_cas_gc_grace_seconds(3600):
        mgr = CheckpointManager(root, keep_last_n=1)
        mgr.save(0, _state(offset=0.0))
        mgr.save(1, _state(offset=1.0))  # drops step 0
        pins, orphans = CASStore(root).load()
        # Step 0's own chunk is dead but fresh: a journaled orphan.
        assert sorted(pins) == [1] and len(orphans) == 1
        assert set(orphans) <= set(_chunk_files(root))
    with knobs.override_cas_gc_grace_seconds(0):
        mgr.save(2, _state(offset=2.0))  # the next pass reclaims
        dead = set(orphans)
        _, orphans = CASStore(root).load()
        assert not orphans and not dead & set(_chunk_files(root))
    dest = _state()
    assert mgr.restore_latest(dest) == 2


def test_concurrent_take_dedup_survives_gc_of_its_source(tmp_path, cas_on) -> None:
    """An in-flight async take dedups against step 0's chunks; a sync save
    then GCs step 0: the grace window keeps the shared chunks, and the
    async step commits restorable."""
    root = str(tmp_path / "ckpt")
    with knobs.override_cas_gc_grace_seconds(3600):
        mgr = CheckpointManager(root, keep_last_n=1)
        state_a = _state(offset=7.0)
        mgr.save(0, state_a)
        pending = mgr.async_save(1, state_a)
        pending.wait(phase="staged")
        mgr.save(2, _state(offset=9.0))
        assert pending.wait() is not None
        dest = _state()
        mgr.restore(1, dest)
        assert torch.equal(dest["m"].tree["w"], state_a["m"].tree["w"])


def test_crash_between_chunk_write_and_refcount_append_heals(tmp_path, cas_on) -> None:
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, keep_last_n=3)
    mgr.save(0, _state(offset=0.0))
    mgr.save(1, _state(offset=1.0))
    os.remove(os.path.join(root, "chunks", ".refcounts.jsonl"))
    mgr2 = CheckpointManager(root, keep_last_n=3)
    pins, _ = CASStore(root).load()
    assert sorted(pins) == [0, 1]
    assert pins[1] == chunk_refs(Snapshot(mgr2.step_path(1)).metadata.manifest)
    assert mgr2.restore_latest(_state()) == 1


def test_torn_journal_tail_is_skipped_and_healed(tmp_path, cas_on) -> None:
    root = str(tmp_path / "ckpt")
    CheckpointManager(root, keep_last_n=3).save(0, _state())
    store = CASStore(root)
    pins_before, _ = store.load()
    with open(store.journal_path, "a") as f:
        f.write('{"op": "pin", "step": 99, "chu')  # a kill mid-append
    assert store.load()[0] == pins_before
    store.pin(42, {"cas-crc32c-1-00000000": 1})  # heals with a newline
    pins, _ = store.load()
    assert 42 in pins and 99 not in pins and 0 in pins


# ---------------------------------------------------------------------------
# mixed layouts + incremental interplay
# ---------------------------------------------------------------------------


def test_mixed_legacy_and_cas_root_restores_both(tmp_path) -> None:
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, keep_last_n=10)
    mgr.save(0, _state(offset=0.0))  # legacy layout
    with knobs.enable_cas():
        mgr.save(1, _state(offset=1.0))  # CAS layout, same root
        dest = _state()
        mgr.restore(0, dest)
        assert torch.equal(dest["m"].tree["w"], _w(offset=0.0))
        mgr.restore(1, dest)
        assert torch.equal(dest["m"].tree["w"], _w(offset=1.0))
    dest = _state()
    mgr.restore(1, dest)  # restore does not read the knob
    assert torch.equal(dest["m"].tree["w"], _w(offset=1.0))


def test_incremental_refs_collapse_onto_chunks(tmp_path, no_grace) -> None:
    """An incremental take over a CAS base names every unchanged chunk at
    its ``../chunks/<key>`` address, with no ``../step_*`` ref: base-step
    GC can never dangle a reference."""
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, keep_last_n=1, incremental=True)
    mgr.save(0, _state(offset=5.0))
    mgr.save(1, _state(offset=5.0))  # unchanged: all refs
    man1 = Snapshot(mgr.step_path(1)).metadata.manifest
    assert referenced_steps(man1) == set()
    assert chunk_refs(man1)
    leftover = [f for _, _, fs in os.walk(os.path.join(root, "step_0000000000")) for f in fs]
    assert leftover == []
    index = json.load(open(os.path.join(root, ".manager_index")))
    assert "pinned" not in index
    dest = _state()
    assert mgr.restore_latest(dest) == 1
    assert torch.equal(dest["m"].tree["w"], _w(offset=5.0))


def test_incremental_skip_avoids_chunk_rewrites(tmp_path, cas_on) -> None:
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, keep_last_n=5, incremental=True)
    mgr.save(0, _state(offset=2.0))
    before = _chunk_files(root)
    written = telemetry.metrics().counters_snapshot().get(names.CAS_BYTES_WRITTEN_TOTAL, 0)
    mgr.save(1, _state(offset=2.0))
    assert _chunk_files(root) == before
    assert telemetry.metrics().counters_snapshot().get(names.CAS_BYTES_WRITTEN_TOTAL, 0) == written


def test_legacy_gc_rederives_refs_for_unmarked_index(tmp_path) -> None:
    """An index without refs bookkeeping holds an incremental step whose
    base a keep_last_n GC would drop: the retention check re-derives refs
    from the retained manifests and pins the base."""
    from torchsnapshot_tpu_torch.fsck import verify_snapshot

    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, keep_last_n=2, incremental=True)
    mgr.save(0, _state(offset=1.0))
    mgr.save(1, _state(offset=1.0))
    assert referenced_steps(Snapshot(mgr.step_path(1)).metadata.manifest) == {0}
    for slot in (".manager_index", ".manager_index.backup"):
        path = os.path.join(root, slot)
        index = json.load(open(path))
        index.pop("refs", None)
        index.pop("refs_complete", None)
        open(path, "w").write(json.dumps(index))
    mgr.save(2, _state(offset=3.0))
    index = json.load(open(os.path.join(root, ".manager_index")))
    assert index.get("pinned") == [0]
    assert index.get("refs", {}).get("1") == [0]
    assert index.get("refs_complete") is True
    assert verify_snapshot(mgr.step_path(1)).ok
    dest = _state()
    mgr.restore(1, dest)
    assert torch.equal(dest["m"].tree["w"], _w(offset=1.0))


# ---------------------------------------------------------------------------
# two processes: identical per-rank leaves stored once
# ---------------------------------------------------------------------------


class ChunkCountingFS(FSStoragePlugin):
    """Accumulates every chunk write this process issues."""

    writes: list = []

    async def write(self, write_io):
        if is_chunk_location(write_io.path):
            ChunkCountingFS.writes.append(write_io.path)
        await super().write(write_io)


def replicated_dedup_worker(pg, root: str) -> dict:
    os.environ["TORCHSNAPSHOT_TPU_CAS"] = "1"
    state = {
        "m": TensorTreeState(
            {
                # Identical on both ranks, saved per rank (not declared
                # replicated): two entries, one stored blob.
                "same": torch.arange(8192, dtype=torch.float32),
                "own": torch.full((1024,), float(pg.rank)),
            }
        )
    }
    with patch_storage_plugin(ChunkCountingFS):
        Snapshot.take(os.path.join(root, "step_0000000001"), state, pg=pg)
        first = list(ChunkCountingFS.writes)
        Snapshot.take(os.path.join(root, "step_0000000002"), state, pg=pg)
        second = [p for p in ChunkCountingFS.writes if p not in first]
    return {"rank": pg.rank, "first": first, "second": second}


def test_two_proc_replicated_rank_dedup(tmp_path) -> None:
    root = str(tmp_path / "ckpt")
    rows = run_multiprocess(replicated_dedup_worker, nproc=2, args=(root,))
    files = _chunk_files(root)
    manifest = Snapshot(os.path.join(root, "step_0000000001")).metadata.manifest
    same_locs = {manifest["0/m/same"].location, manifest["1/m/same"].location}
    assert len(same_locs) == 1
    assert key_of_location(next(iter(same_locs))) in files
    # 'same' once and 'own' per rank: 3 chunk files.
    assert len(files) == 3
    for row in rows:
        assert row["second"] == []
    for rank in (0, 1):
        dest = {"m": TensorTreeState({"same": torch.zeros(8192), "own": torch.zeros(1024)})}
        Snapshot(os.path.join(root, "step_0000000002")).read_object(f"{rank}/m/own", dest["m"].tree["own"])
        assert torch.equal(dest["m"].tree["own"], torch.full((1024,), float(rank)))


# ---------------------------------------------------------------------------
# fsck --cas, repair
# ---------------------------------------------------------------------------


def test_fsck_cas_store_audit(tmp_path, cas_on) -> None:
    from torchsnapshot_tpu_torch.fsck import main as fsck_main, verify_cas_store

    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, keep_last_n=5)
    for i in range(3):
        mgr.save(i, _state(offset=float(i)))
    report = verify_cas_store(root, deep=True)
    assert report.ok and report.steps == [0, 1, 2]
    assert report.crcs_verified == report.chunks_referenced
    # 3 'w' variants and one shared 'frozen': 4 stored, 6 referenced.
    assert report.chunks_present == 4 and report.dedup_ratio > 1.1
    assert report.bytes_per_retained_step > 0
    assert fsck_main([root, "--cas", "--deep"]) == 0

    cdir = os.path.join(root, "chunks")
    victim = sorted(_chunk_files(root))[0]
    with open(os.path.join(cdir, victim), "r+b") as f:
        f.seek(3)
        f.write(b"\x99")
    assert any(p.kind == "checksum" for p in verify_cas_store(root, deep=True).problems)
    os.remove(os.path.join(cdir, victim))
    assert any(p.kind == "missing" and victim in p.location for p in verify_cas_store(root).problems)
    assert fsck_main([root, "--cas"]) == 1
    # An unreferenced chunk is listed, never a failure.
    stray = digest_key(compute_checksum_entry(b"stray bytes"))
    open(os.path.join(cdir, stray), "wb").write(b"stray bytes")
    report = verify_cas_store(root)
    assert stray in report.unreferenced
    assert not any(stray in p.location for p in report.problems)


def test_fsck_cas_repair_quarantines_a_damaged_chunk(tmp_path, cas_on, capsys) -> None:
    """A root has one copy of each chunk: a damaged one is moved to
    ``chunks/.quarantine/`` and its ref then dangles loudly."""
    from torchsnapshot_tpu_torch.fsck import main as fsck_main, repair_cas_store, verify_cas_store

    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root)
    mgr.save(0, _state())
    assert repair_cas_store(root).checked == 2 and not repair_cas_store(root).acted
    victim = key_of_location(Snapshot(mgr.step_path(0)).metadata.manifest["0/m/w"].location)
    with open(os.path.join(root, "chunks", victim), "r+b") as f:
        f.write(b"\x00\x01")
    assert fsck_main([root, "--cas", "--repair"]) == 1
    assert f"FSCK quarantined: chunks/{victim}" in capsys.readouterr().out
    assert os.path.exists(os.path.join(root, "chunks", ".quarantine", victim))
    assert [p.kind for p in verify_cas_store(root).problems] == ["missing"]
    # Without --cas, --repair of a one-tier snapshot has nothing to rebuild.
    assert fsck_main([mgr.step_path(0), "--repair"]) == 1
    assert "repair: nothing to do" in capsys.readouterr().out


@pytest.mark.parametrize("argv, step", [(["--tier", "fast"], None), (["--stats"], "10d")], ids=["tier", "stats"])
def test_fsck_tier_and_stats_stay_refused(tmp_path, argv, step, capsys) -> None:
    """Both are ported. ``--stats`` (step 10d) audits a CAS take, then
    lists its report and the doctor's verdicts. ``--tier`` audits one
    tier of a ``tiered://`` snapshot, here a CAS one whose data sits in
    the fast tier's chunk store."""
    from torchsnapshot_tpu_torch.fsck import main as fsck_main
    from torchsnapshot_tpu_torch.tiered import reset_mirror

    if step is not None:
        with knobs.enable_cas(), knobs.enable_telemetry():
            mgr = CheckpointManager(str(tmp_path / "root"))
            mgr.save(0, _state())
        assert fsck_main([mgr.step_path(0), *argv]) == 0
        out = capsys.readouterr().out
        assert "telemetry (1 event(s)):" in out and "OK (shallow)" in out
        return
    reset_mirror()
    try:
        with knobs.enable_cas():
            mgr = CheckpointManager(f"tiered://{tmp_path / 'fast'}|{tmp_path / 'durable'}")
            mgr.save(0, _state())
            mgr.wait_durable(0, timeout=60)
    finally:
        reset_mirror()
    assert fsck_main([mgr.step_path(0), "--deep", *argv]) == 0
    assert "OK (deep)" in capsys.readouterr().out
    assert _chunk_files(tmp_path / "fast") and _chunk_files(tmp_path / "fast") == _chunk_files(tmp_path / "durable")


def test_gc_sweeps_stray_unpinned_chunks(tmp_path, no_grace) -> None:
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, keep_last_n=1)
    mgr.save(0, _state(offset=0.0))
    stray = digest_key(compute_checksum_entry(b"crashed take bytes"))
    stray_path = os.path.join(root, "chunks", stray)
    open(stray_path, "wb").write(b"crashed take bytes")
    mgr.save(1, _state(offset=1.0))
    assert not os.path.exists(stray_path)
    assert mgr.restore_latest(_state()) == 1


def test_gc_stray_sweep_defers_fresh_chunks(tmp_path, cas_on) -> None:
    root = str(tmp_path / "ckpt")
    with knobs.override_cas_gc_grace_seconds(3600):
        mgr = CheckpointManager(root, keep_last_n=1)
        mgr.save(0, _state(offset=0.0))
        inflight = digest_key(compute_checksum_entry(b"in-flight bytes"))
        inflight_path = os.path.join(root, "chunks", inflight)
        open(inflight_path, "wb").write(b"in-flight bytes")
        mgr.save(1, _state(offset=1.0))
        assert os.path.exists(inflight_path)
        store = CASStore(root)
        assert inflight in store.load()[1]
        store.pin(99, {inflight: len(b"in-flight bytes")})
        store.clear_orphans([inflight])
        assert inflight not in store.load()[1]


def test_reconcile_heals_partially_lost_pin(tmp_path, no_grace) -> None:
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, keep_last_n=3)
    mgr.save(0, _state(offset=0.0))
    mgr.save(1, _state(offset=1.0))
    del mgr
    store = CASStore(root)
    pins, orphans = store.load()
    assert sorted(pins) == [0, 1]
    step0_chunks = set(pins.pop(0))
    store.compact(pins, orphans)
    mgr2 = CheckpointManager(root, keep_last_n=3)
    pins, _ = CASStore(root).load()
    assert sorted(pins) == [0, 1] and set(pins[0]) == step0_chunks
    mgr2.save(2, _state(offset=2.0))
    assert step0_chunks <= set(_chunk_files(root))
    assert torch.equal(_restored_w(mgr2.step_path(0)), _w(offset=0.0))


def test_gc_runs_without_retention_deletes(tmp_path, no_grace) -> None:
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root)  # no retention
    mgr.save(0, _state(offset=0.0))
    stray = digest_key(compute_checksum_entry(b"crashed take bytes"))
    stray_path = os.path.join(root, "chunks", stray)
    open(stray_path, "wb").write(b"crashed take bytes")
    mgr.save(1, _state(offset=1.0))
    assert not os.path.exists(stray_path)
    assert mgr.restore_latest(_state()) == 1


# ---------------------------------------------------------------------------
# both packages on one chunk store
# ---------------------------------------------------------------------------


def test_jax_cas_snapshot_restores_in_the_port_and_back(tmp_path, cas_on) -> None:
    """Each package's CAS take of the same leaves names the same chunks,
    and each restores the other's bit for bit."""
    import torchsnapshot_tpu as jts

    jax_path = str(tmp_path / "jax_root" / "step_0000000001")
    port_path = str(tmp_path / "port_root" / "step_0000000001")
    jts.Snapshot.take(jax_path, _jax_state(offset=2.0))
    Snapshot.take(port_path, _state(offset=2.0))
    jax_refs = chunk_refs(Snapshot(jax_path).metadata.manifest)
    assert jax_refs and jax_refs == chunk_refs(Snapshot(port_path).metadata.manifest)
    assert _chunk_files(tmp_path / "jax_root") == _chunk_files(tmp_path / "port_root")
    # The chunk maps, and the checksum tables keyed by chunk location, are
    # byte for byte the same.
    for blob in ("cas/0", "checksums/0"):
        with open(os.path.join(jax_path, blob), "rb") as f, open(os.path.join(port_path, blob), "rb") as g:
            assert f.read() == g.read(), blob
    assert torch.equal(_restored_w(jax_path), _w(offset=2.0))
    dest = _jax_state(offset=-1.0)
    jts.Snapshot(port_path).restore(dest)
    np.testing.assert_array_equal(dest["m"].tree["w"], np.arange(N, dtype=np.float32) + 2.0)


def test_refcount_journals_match_byte_for_byte(tmp_path, no_grace) -> None:
    """The same three saves with keep_last_n=2 through each package's
    manager leave identical journals (pins, unpin, compaction aside)."""
    import torchsnapshot_tpu as jts

    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    jmgr, pmgr = jts.CheckpointManager(jroot, keep_last_n=2), CheckpointManager(proot, keep_last_n=2)
    for step in range(3):
        jmgr.save(step, _jax_state(offset=float(step)))
        pmgr.save(step, _state(offset=float(step)))
    assert _journal(jroot) == _journal(proot)
    assert _chunk_files(jroot) == _chunk_files(proot)


def test_jax_lease_survives_the_port_gc(tmp_path, no_grace) -> None:
    """A chunk that a JAX-package lease holds (a CDN subscriber's) is live
    for the port's GC, and the port's compaction keeps the lease."""
    from torchsnapshot_tpu.cas import CASStore as JaxStore

    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, keep_last_n=1)
    mgr.save(0, _state(offset=0.0))
    held = key_of_location(Snapshot(mgr.step_path(0)).metadata.manifest["0/m/w"].location)
    JaxStore(root).lease("subscriber", {held: N * 4})
    mgr.save(1, _state(offset=1.0))  # drops step 0; its w chunk stays leased
    assert held in _chunk_files(root)
    store = CASStore(root)
    pins, orphans, leases = store.load_full()
    store.compact(pins, orphans)
    assert store.load_full()[2] == {"subscriber": {held: N * 4}}


def _journal(root) -> list:
    with open(os.path.join(root, "chunks", ".refcounts.jsonl")) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_each_manager_reconciles_and_collects_the_others_root(tmp_path, no_grace, first) -> None:
    """One package manages a CAS root for two steps; the other loads it,
    heals a lost journal, saves two more steps with keep_last_n=2 (its GC
    reclaims the first package's dead chunks) and restores the newest;
    then the first package restores it too and each fsck --cas --deep
    passes the root."""
    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.fsck import verify_cas_store as jax_verify

    from torchsnapshot_tpu_torch.fsck import verify_cas_store

    root = str(tmp_path / "root")

    def port_mgr():
        return CheckpointManager(root, keep_last_n=2)

    def jax_mgr():
        return jts.CheckpointManager(root, keep_last_n=2)

    def save(which, mgr, step):
        if which == "jax":
            mgr.save(step, _jax_state(offset=float(step)))
        else:
            mgr.save(step, _state(offset=float(step)))

    second = "port" if first == "jax" else "jax"
    make = {"jax": jax_mgr, "port": port_mgr}
    mgr = make[first]()
    save(first, mgr, 0)
    save(first, mgr, 1)
    assert _journal(root)  # the first package's pins
    os.remove(os.path.join(root, "chunks", ".refcounts.jsonl"))
    mgr = make[second]()  # reconciles from the index and manifests
    pins, _ = CASStore(root).load()
    assert sorted(pins) == [0, 1]
    step0_w = key_of_location(Snapshot(os.path.join(root, "step_0000000000")).metadata.manifest["0/m/w"].location)
    save(second, mgr, 2)
    save(second, mgr, 3)
    pins, orphans = CASStore(root).load()
    assert sorted(pins) == [2, 3] and not orphans
    files = _chunk_files(root)
    assert step0_w not in files and len(files) == 3  # w of steps 2 and 3, shared frozen
    assert torch.equal(_restored_w(os.path.join(root, "step_0000000003")), _w(offset=3.0))
    dest = _jax_state(offset=-1.0)
    assert jax_mgr().restore_latest(dest) == 3
    np.testing.assert_array_equal(dest["m"].tree["w"], np.arange(N, dtype=np.float32) + 3.0)
    for report in (verify_cas_store(root, deep=True), jax_verify(root, deep=True)):
        assert report.ok and report.steps == [2, 3], report.problems
        assert report.crcs_verified == report.chunks_referenced == 3


def test_jax_incremental_takes_over_a_port_cas_base(tmp_path, cas_on) -> None:
    """Digest-recorded steps of either package chain: the JAX package's
    incremental save over the port's CAS step references its chunks, not
    its step."""
    import torchsnapshot_tpu as jts

    root = str(tmp_path / "root")
    CheckpointManager(root, incremental=True).save(0, _state(offset=4.0))
    jmgr = jts.CheckpointManager(root, incremental=True)
    jmgr.save(1, _jax_state(offset=4.0))
    man1 = Snapshot(os.path.join(root, "step_0000000001")).metadata.manifest
    assert referenced_steps(man1) == set()
    assert chunk_refs(man1) == chunk_refs(Snapshot(os.path.join(root, "step_0000000000")).metadata.manifest)
    assert torch.equal(_restored_w(os.path.join(root, "step_0000000001")), _w(offset=4.0))


# ---------------------------------------------------------------------------
# the mirror of a tiered root ships chunks, not steps
# ---------------------------------------------------------------------------


@pytest.fixture
def tiered_root(tmp_path):
    """``(root URL, fast root dir, durable root dir)`` of a tiered manager
    root, with a fresh process mirror around the test."""
    from torchsnapshot_tpu_torch.tiered import reset_mirror

    fast, dur = tmp_path / "fast" / "ckpt", tmp_path / "dur" / "ckpt"
    reset_mirror()
    yield f"tiered://{fast}|{dur}", str(fast), str(dur)
    reset_mirror()


def test_mirror_ships_only_novel_chunks(tiered_root, cas_on) -> None:
    """A second identical step ships only its control blobs: the mirror's
    one-byte probe finds every data chunk on the durable tier already."""
    import shutil

    from torchsnapshot_tpu_torch.tiered import get_mirror

    root, fast, dur = tiered_root
    mgr = CheckpointManager(root, keep_last_n=4)
    mgr.save(0, _state(offset=6.0))
    mgr.wait_durable(0)
    shipped_first = get_mirror().metrics()["bytes_mirrored"]
    mgr.save(1, _state(offset=6.0))
    mgr.wait_durable(1)
    shipped_second = get_mirror().metrics()["bytes_mirrored"] - shipped_first
    state_bytes = N * 4 + N // 4 * 4
    assert shipped_first > state_bytes
    assert shipped_second < state_bytes / 4
    assert sorted(_chunk_files(dur)) == sorted(_chunk_files(fast))
    shutil.rmtree(os.path.dirname(fast))
    dest = _state()
    assert CheckpointManager(root, keep_last_n=4).restore_latest(dest) == 1
    assert torch.equal(dest["m"].tree["w"], _w(offset=6.0))


def test_mirror_reships_deduped_chunk_missing_from_durable(tiered_root, cas_on) -> None:
    """A dedup hit writes nothing, but the step's durability covers the
    chunk: a chunk the durable tier lost rides the next step's mirror job
    and ships again. The port claims a chunk before its write (ROADMAP
    queue 3); a claimed chunk still goes to the mirror."""
    import shutil

    root, fast, dur = tiered_root
    mgr = CheckpointManager(root, keep_last_n=4)
    mgr.save(0, _state(offset=8.0))
    mgr.wait_durable(0)
    victim = sorted(_chunk_files(dur))[0]
    os.remove(os.path.join(dur, "chunks", victim))
    mgr.save(1, _state(offset=8.0))  # identical: pure dedup
    mgr.wait_durable(1)
    assert victim in _chunk_files(dur)
    shutil.rmtree(os.path.dirname(fast))
    dest = _state()
    assert CheckpointManager(root, keep_last_n=4).restore_latest(dest) == 1
    assert torch.equal(dest["m"].tree["w"], _w(offset=8.0))


def test_mirror_reships_torn_durable_chunk(tiered_root, cas_on) -> None:
    """The mirror's probe reads a chunk's last byte, which the key's
    length names: a truncated durable copy misses it and is overwritten
    whole."""
    root, fast, dur = tiered_root
    mgr = CheckpointManager(root, keep_last_n=4)
    mgr.save(0, _state(offset=9.0))
    mgr.wait_durable(0)
    victim = sorted(_chunk_files(dur))[0]
    want = nbytes_of_key(victim)
    with open(os.path.join(dur, "chunks", victim), "r+b") as f:
        f.truncate(want // 2)
    mgr.save(1, _state(offset=9.0))
    mgr.wait_durable(1)
    assert os.path.getsize(os.path.join(dur, "chunks", victim)) == want


def test_fsck_cas_flags_torn_copy_in_one_tier(tiered_root, cas_on) -> None:
    """A truncated chunk copy on one tier is a finding even when the other
    tier holds the full bytes; the JAX package's fsck agrees."""
    from torchsnapshot_tpu.fsck import verify_cas_store as jax_verify_cas_store
    from torchsnapshot_tpu_torch.fsck import verify_cas_store
    from torchsnapshot_tpu_torch.tiered import get_mirror

    root, fast, dur = tiered_root
    mgr = CheckpointManager(root, keep_last_n=4)
    mgr.save(0, _state(offset=11.0))
    mgr.wait_durable(0)
    assert get_mirror().drain(timeout=60)
    assert verify_cas_store(root).ok and jax_verify_cas_store(root).ok
    victim = sorted(_chunk_files(dur))[0]
    with open(os.path.join(dur, "chunks", victim), "r+b") as f:
        f.truncate(nbytes_of_key(victim) // 2)
    for report in (verify_cas_store(root), jax_verify_cas_store(root)):
        assert any(
            p.kind == "truncated" and victim in p.location and os.path.join(dur, "chunks") in p.detail
            for p in report.problems
        ), report.problems
