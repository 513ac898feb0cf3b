"""The chaos engine and the self-healing store in the port (``chaos/``,
the scheduler's ladder, ``fsck --repair`` across tiers).

Port of the JAX package's ``tests/test_chaos.py``: fault-plan replay
determinism, the injection modes over real plugins and over the TCP
store's wire, crash-point arming, the restore-time corruption ladder and
the repair matrix of one corrupt chunk per tier (fall through, rewrite,
quarantine). Where the JAX file reads its restore report and doctor
verdicts, these read the port's ``restore_telemetry`` and the
``storage_degraded_reads_total`` counter.
Its peer-ladder case holds the port's ladder the same way. Added here: one
``FaultPlan`` JSON line fires the same schedule under both packages'
engines, and a ``cuda_only`` tiered take and restore of CUDA leaves whose
fast copy is corrupt, compared bit for bit.
"""

import glob
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, TensorTreeState, knobs, telemetry
from torchsnapshot_tpu_torch.chaos import (
    ChaosEngine,
    FaultPlan,
    FaultSpec,
    SimulatedCrash,
    arm,
    arm_engine,
    corrupt_bytes,
    crashpoint,
    declared_crashpoints,
    disarm,
    hits,
    install_wire_chaos,
    uninstall_wire_chaos,
    wrap_plugin,
)
from torchsnapshot_tpu_torch.event_loop import run_in_fresh_event_loop
from torchsnapshot_tpu_torch.integrity import ChecksumError
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.telemetry import names
from torchsnapshot_tpu_torch.tiered import reset_mirror

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_mirror():
    reset_mirror()
    yield
    reset_mirror()


def _flip_middle_byte(path: str) -> None:
    """Size-preserving on-disk corruption: only a digest catches it."""
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 1]))


def _degraded(tier: str) -> float:
    from torchsnapshot_tpu_torch.telemetry.registry import series_key

    key = series_key(names.STORAGE_DEGRADED_READS_TOTAL, {"tier": tier})
    return telemetry.metrics().counters_snapshot().get(key, 0.0)


# ---------------------------------------------------------------------------
# fault plans + engine
# ---------------------------------------------------------------------------


def test_fault_plan_json_round_trip() -> None:
    plan = FaultPlan(
        seed=42,
        faults=[
            FaultSpec(point="storage-write", mode="torn", match="m/", after=2),
            FaultSpec(point="crashpoint", mode="crash", match="commit-marker", times=None, prob=0.25),
        ],
    )
    line = plan.to_json()
    assert "\n" not in line
    again = FaultPlan.from_json(line)
    assert again.to_json() == line
    assert again.seed == 42
    assert [f.mode for f in again.faults] == ["torn", "crash"]


def test_unknown_mode_rejected() -> None:
    with pytest.raises(ValueError, match="unknown fault mode"):
        FaultSpec(point="storage-write", mode="explode")


def test_same_seed_same_schedule() -> None:
    """The same seed and plan over the same event stream fire the same
    schedule; another seed diverges."""
    plan_line = FaultPlan(
        seed=7, faults=[FaultSpec(point="storage-write", mode="fail", prob=0.3, times=None)]
    ).to_json()
    events = [("storage-write", f"blob-{i}") for i in range(200)]

    def schedule(line: str):
        engine = ChaosEngine(FaultPlan.from_json(line))
        for point, key in events:
            engine.on_event(point, key)
        return list(engine.fired)

    first = schedule(plan_line)
    assert first and first == schedule(plan_line)
    other = FaultPlan.from_json(plan_line)
    other.seed = 8
    assert schedule(other.to_json()) != first


def test_after_and_times_windows() -> None:
    engine = ChaosEngine(FaultPlan.single(point="storage-read", after=2, times=2))
    outcomes = [engine.on_event("storage-read", "b") is not None for _ in range(6)]
    assert outcomes == [False, False, True, True, False, False]


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_one_plan_line_fires_the_same_schedule_in_both_engines(seed) -> None:
    """A red run's one JSON line replays under either package: the JAX
    engine and the port's fire the same (point, key, mode) schedule on
    the same event stream, and each parses the other's line to the same
    line."""
    from torchsnapshot_tpu.chaos import ChaosEngine as JaxEngine, FaultPlan as JaxPlan

    plan = FaultPlan(
        seed=seed,
        faults=[
            FaultSpec(point="storage-write", mode="corrupt", match="m/", prob=0.4, times=None),
            FaultSpec(point="storage-read", mode="fail", after=3, times=5, prob=0.5),
            FaultSpec(point="crashpoint", mode="crash", match="commit-marker", after=1),
            FaultSpec(point="wire-send", mode="delay", delay_s=0.5, prob=0.2, times=None),
        ],
    )
    line = plan.to_json()
    assert JaxPlan.from_json(line).to_json() == line
    assert FaultPlan.from_json(JaxPlan.from_json(line).to_json()).to_json() == line
    rng = np.random.default_rng(seed)
    points = ["storage-write", "storage-read", "crashpoint", "wire-send"]
    events = [
        (points[int(rng.integers(4))], f"{'m/' if rng.random() < 0.5 else 'x/'}{i}")
        for i in range(400)
    ] + [("crashpoint", "commit-marker")] * 3
    port, jax = ChaosEngine(FaultPlan.from_json(line)), JaxEngine(JaxPlan.from_json(line))
    for point, key in events:
        a, b = port.on_event(point, key), jax.on_event(point, key)
        assert (a is None) == (b is None)
    assert port.fired and port.fired == jax.fired


# ---------------------------------------------------------------------------
# storage injection modes
# ---------------------------------------------------------------------------


def _mem_plugin(plan: FaultPlan):
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

    inner = MemoryStoragePlugin(name=f"chaos-{id(plan)}")
    return inner, wrap_plugin(inner, ChaosEngine(plan))


def test_mode_fail_and_delay_and_drop() -> None:
    inner, plugin = _mem_plugin(
        FaultPlan(
            seed=0,
            faults=[
                FaultSpec(point="storage-write", mode="fail", match="dead"),
                FaultSpec(point="storage-write", mode="drop", match="lost"),
                FaultSpec(point="storage-write", mode="delay", match="slow", delay_s=0.01),
            ],
        )
    )

    async def body():
        with pytest.raises(OSError, match="chaos: injected fault"):
            await plugin.write(WriteIO(path="dead", buf=b"x"))
        await plugin.write(WriteIO(path="lost", buf=b"x"))  # reported ok
        await plugin.write(WriteIO(path="slow", buf=b"abc"))
        await plugin.write(WriteIO(path="fine", buf=b"def"))
        read = ReadIO(path="slow")
        await plugin.read(read)
        assert bytes(read.buf) == b"abc"
        with pytest.raises(FileNotFoundError):
            await plugin.read(ReadIO(path="lost"))  # the write was dropped

    run_in_fresh_event_loop(body())


def test_mode_corrupt_and_torn() -> None:
    inner, plugin = _mem_plugin(
        FaultPlan(
            seed=0,
            faults=[
                FaultSpec(point="storage-write", mode="corrupt", match="bitrot"),
                FaultSpec(point="storage-write", mode="torn", match="torn"),
                FaultSpec(point="storage-read", mode="corrupt", match="readrot"),
            ],
        )
    )

    async def body():
        payload = bytes(range(64))
        await plugin.write(WriteIO(path="bitrot", buf=payload))
        read = ReadIO(path="bitrot")
        await inner.read(read)
        stored = bytes(read.buf)
        assert len(stored) == len(payload) and stored != payload

        with pytest.raises(OSError, match="torn write"):
            await plugin.write(WriteIO(path="torn", buf=payload))
        read = ReadIO(path="torn")
        await inner.read(read)
        assert bytes(read.buf) == payload[: len(payload) // 2]

        await inner.write(WriteIO(path="readrot", buf=payload))
        read = ReadIO(path="readrot")
        await plugin.read(read)
        assert bytes(read.buf) != payload
        assert len(bytes(read.buf)) == len(payload)

    run_in_fresh_event_loop(body())


def test_corrupt_bytes_is_size_preserving() -> None:
    data = bytes(range(32))
    damaged = corrupt_bytes(data)
    assert len(damaged) == len(data) and damaged != data
    assert corrupt_bytes(b"") == b""


def test_faulty_fs_plugin_corrupt_mode_never_served_silently(tmp_path) -> None:
    """The shim's corrupt mode on a single-tier root: no other copy, so
    the damage surfaces as a ChecksumError, never as wrong tensors."""
    from torchsnapshot_tpu_torch.test_utils import faulty_fs_plugin, patch_storage_plugin

    path = str(tmp_path / "s")
    Snapshot.take(path, {"m": TensorTreeState({"w": torch.arange(5000, dtype=torch.float32)})})
    cls = faulty_fs_plugin(lambda p: "/m/" in p, ops=("read",), mode="corrupt")
    dst = {"m": TensorTreeState({"w": torch.zeros(5000)})}
    with patch_storage_plugin(cls), pytest.raises(ChecksumError):
        Snapshot(path).restore(dst)
    assert cls.chaos_engine.fired
    assert not dst["m"].tree["w"].any()  # nothing was placed


def test_faulty_fs_plugin_torn_mode_fails_the_take(tmp_path) -> None:
    """The shim's torn mode: half the bytes land, the write raises, the
    take fails with no commit marker, and a clean retake restores."""
    from torchsnapshot_tpu_torch.test_utils import faulty_fs_plugin, patch_storage_plugin

    path = str(tmp_path / "s")
    state = {"m": TensorTreeState({"w": torch.arange(5000, dtype=torch.float32)})}
    cls = faulty_fs_plugin(lambda p: "/m/" in p, ops=("write",), mode="torn")
    with patch_storage_plugin(cls), pytest.raises(OSError, match="torn write"):
        Snapshot.take(path, state)
    assert cls.chaos_engine.fired[0][2] == "torn"
    assert 0 < os.path.getsize(os.path.join(path, "0", "m", "w")) < 5000 * 4
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))
    Snapshot.take(path, state)
    dst = {"m": TensorTreeState({"w": torch.zeros(5000)})}
    Snapshot(path).restore(dst)
    assert torch.equal(dst["m"].tree["w"], state["m"].tree["w"])


# ---------------------------------------------------------------------------
# wire chaos (the TCP store's send_frame / recv_frame)
# ---------------------------------------------------------------------------


def test_wire_chaos_fails_store_traffic_then_uninstalls() -> None:
    from torchsnapshot_tpu_torch.dist_store import TCPStore
    from torchsnapshot_tpu_torch.test_utils import get_free_port

    store = TCPStore("127.0.0.1", get_free_port(), is_server=True)
    try:
        store.set("before", b"1")
        engine = ChaosEngine(FaultPlan.single(point="wire-send", mode="fail"))
        install_wire_chaos(engine)
        try:
            with pytest.raises((ConnectionError, OSError)):
                store.set("during", b"2")
            assert engine.fired and engine.fired[0][0] == "wire-send"
        finally:
            uninstall_wire_chaos()
        store.set("after", b"3")
        assert store.try_get("after") == b"3"
    finally:
        store.close()


def test_chaos_store_fails_and_drops_coordination_ops() -> None:
    """The store wrapper rides the engine on the four primitive ops, so
    every collective built on them (here ``multi_set``'s per-key
    fallback) sees the same faults."""
    from torchsnapshot_tpu_torch.chaos import ChaosStore
    from torchsnapshot_tpu_torch.dist_store import InProcessStore

    inner = InProcessStore()
    store = ChaosStore(
        inner,
        ChaosEngine(
            FaultPlan(
                seed=0,
                faults=[
                    FaultSpec(point="store-set", mode="fail", match="dead"),
                    FaultSpec(point="store-set", mode="drop", match="lost", times=None),
                    FaultSpec(point="store-get", mode="drop", match="hidden"),
                    FaultSpec(point="store-add", mode="drop", match="ctr"),
                ],
            )
        ),
    )
    with pytest.raises(ConnectionError, match="chaos: injected fault"):
        store.set("dead", b"1")
    store.set("lost", b"1")
    assert inner.try_get("lost") is None  # the set was swallowed
    store.set("hidden", b"2")
    assert inner.try_get("hidden") == b"2" and store.try_get("hidden") is None
    with pytest.raises(ConnectionError, match="dropped store-add"):
        store.add("ctr", 1)
    store.multi_set({"a": b"x", "lost-too": b"y"})
    assert inner.try_get("a") == b"x" and inner.try_get("lost-too") is None


# ---------------------------------------------------------------------------
# crash points
# ---------------------------------------------------------------------------


def test_crashpoint_arm_disarm_and_hits() -> None:
    point = names.CRASH_COMMIT_MARKER
    crashpoint(point)  # unarmed: a no-op
    arm(point, at=2)
    try:
        crashpoint(point)
        with pytest.raises(SimulatedCrash):
            crashpoint(point)
        assert hits(point) == 2
    finally:
        disarm()
    crashpoint(point)


@pytest.mark.parametrize("point", ["take-writes-done", "pre-commit-marker", "commit-marker", "peer-enqueued"])
def test_kill_inside_the_async_commit_thread(tmp_path, point) -> None:
    """A kill on the async commit thread reaches ``wait()``; before the
    commit marker it leaves none behind. The next clean batched and
    packed async take in the same process neither hangs nor fails (the
    staging pool's and the pack's slots were released)."""
    state = {"m": TensorTreeState({f"l{i}": torch.arange(4096, dtype=torch.float32) + i for i in range(6)})}
    path = str(tmp_path / "killed")
    # An exact match: a plan's ``match`` is a substring, so ``arm(
    # "commit-marker")`` fires first at "pre-commit-marker", in both packages.
    plan = FaultPlan(faults=[FaultSpec(point="crashpoint", mode="crash", predicate=lambda key: key == point)])
    with knobs.enable_batching(), knobs.enable_device_pack():
        arm_engine(ChaosEngine(plan))
        try:
            pending = Snapshot.async_take(path, state)
            with pytest.raises(SimulatedCrash):
                pending.wait()
        finally:
            disarm()
        committed = os.path.exists(os.path.join(path, ".snapshot_metadata"))
        assert committed == (point in ("commit-marker", "peer-enqueued"))
        snapshot = Snapshot.async_take(str(tmp_path / "clean"), state).wait()
    dst = {"m": TensorTreeState({k: torch.zeros_like(v) for k, v in state["m"].tree.items()})}
    snapshot.restore(dst)
    for k, v in state["m"].tree.items():
        assert torch.equal(dst["m"].tree[k], v)


def test_declared_crashpoints_enumerates_names_registry() -> None:
    from torchsnapshot_tpu.chaos import declared_crashpoints as jax_declared

    declared = declared_crashpoints()
    assert names.CRASH_COMMIT_MARKER in declared
    assert names.CRASH_CAS_CHUNK_WRITTEN in declared
    assert names.CRASH_INDEX_BACKUP_WRITTEN in declared
    assert len(declared) >= 13
    assert declared == sorted(declared) == jax_declared()
    assert issubclass(SimulatedCrash, BaseException)
    assert not issubclass(SimulatedCrash, Exception)


# ---------------------------------------------------------------------------
# self-healing reads (the corruption ladder)
# ---------------------------------------------------------------------------


def _tiered_root(tmp_path):
    fast = str(tmp_path / "fast")
    durable = str(tmp_path / "durable")
    return f"tiered://{fast}|{durable}", fast, durable


def test_tiered_restore_heals_around_corrupt_fast_copy(tmp_path) -> None:
    """Corruption on the tier restores read first falls through to the
    other tier: the restore is bit-identical, its telemetry carries the
    rerouted bytes, and the degraded-read counter names the tier."""
    root, fast, durable = _tiered_root(tmp_path)
    want = torch.arange(80_000, dtype=torch.float32)
    mgr = CheckpointManager(root, keep_last_n=2)
    mgr.save(0, {"m": TensorTreeState({"w": want.clone()})})
    mgr.wait_durable(0)
    _flip_middle_byte(os.path.join(fast, "step_0000000000", "0", "m", "w"))
    before = _degraded("durable")
    dest = {"m": TensorTreeState({"w": torch.zeros_like(want)})}
    snapshot = Snapshot(mgr.step_path(0))
    snapshot.restore(dest)
    assert torch.equal(dest["m"].tree["w"], want)
    nbytes = want.numel() * 4
    assert snapshot.restore_telemetry["degraded_reads"] == {"blobs": 1, "bytes": nbytes}
    assert snapshot.restore_telemetry["tier_split"] == {"durable": nbytes}
    assert _degraded("durable") == before + 1


def test_peer_ladder_healing_does_not_double_count_tiers(tmp_path) -> None:
    """The peer ladder's ``read_degraded`` takes back the rejected serve's
    bytes: ``tier_split`` sums to the bytes restored, not to those plus
    every corrupt attempt."""
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.tiered.peer import PeerRestoreContext
    from torchsnapshot_tpu_torch.tiered.plugin import TieredStoragePlugin

    fast, durable = str(tmp_path / "f"), str(tmp_path / "d")
    payload = bytes(range(256)) * 4
    for tier in (fast, durable):
        os.makedirs(tier)
        with open(os.path.join(tier, "blob"), "wb") as f:
            f.write(payload)
    _flip_middle_byte(os.path.join(fast, "blob"))
    tiered = TieredStoragePlugin(fast=FSStoragePlugin(root=fast), durable=FSStoragePlugin(root=durable))
    ctx = PeerRestoreContext(table={}, step_key="s", timeout=0.5)
    ladder = ctx.wrap(tiered)

    async def body():
        read = ReadIO(path="blob")
        await ladder.read(read)  # the fast tier serves, corrupt, and is counted
        assert read.served_by == "fast"
        assert await ladder.read_degraded(read)  # the scheduler's retry
        assert read.served_by == "durable"
        assert bytes(read.buf) == payload

    run_in_fresh_event_loop(body())
    split = ctx.pipeline_fields()["tier_split"]
    assert sum(split.values()) == len(payload), split
    assert split["durable"] == len(payload) and split["fast"] == 0


def test_single_tier_corruption_still_raises(tmp_path) -> None:
    """No other copy, no silent serve: the original ChecksumError stands."""
    path = str(tmp_path / "s")
    want = torch.arange(50_000, dtype=torch.float32)
    Snapshot.take(path, {"m": TensorTreeState({"w": want.clone()})})
    _flip_middle_byte(os.path.join(path, "0", "m", "w"))
    dest = {"m": TensorTreeState({"w": torch.zeros_like(want)})}
    with pytest.raises(ChecksumError):
        Snapshot(path).restore(dest)


def test_tiered_corruption_in_both_tiers_raises(tmp_path) -> None:
    """Both copies damaged: the ladder runs out and the ChecksumError
    stands; nothing is counted as healed."""
    root, fast, durable = _tiered_root(tmp_path)
    want = torch.arange(50_000, dtype=torch.float32)
    mgr = CheckpointManager(root)
    mgr.save(0, {"m": TensorTreeState({"w": want.clone()})})
    mgr.wait_durable(0)
    for tier in (fast, durable):
        _flip_middle_byte(os.path.join(tier, "step_0000000000", "0", "m", "w"))
    before = (_degraded("durable"), _degraded("fast"))
    dest = {"m": TensorTreeState({"w": torch.zeros_like(want)})}
    with pytest.raises(ChecksumError):
        mgr.restore_latest(dest)
    assert (_degraded("durable"), _degraded("fast")) == before


# ---------------------------------------------------------------------------
# CAS chunk repair: one corrupt chunk per tier
# ---------------------------------------------------------------------------


def _cas_setup(tmp_path):
    root, fast, durable = _tiered_root(tmp_path)
    want = torch.arange(60_000, dtype=torch.float32)
    mgr = CheckpointManager(root, keep_last_n=2)
    mgr.save(0, {"m": TensorTreeState({"w": want.clone()})})
    mgr.wait_durable(0)
    chunks = sorted(glob.glob(os.path.join(durable, "chunks", "cas-*")))
    assert chunks, "CAS layout did not engage"
    return root, fast, durable, want, mgr, os.path.basename(chunks[0])


def _chunk_bytes(tier_dir: str, key: str) -> bytes:
    with open(os.path.join(tier_dir, "chunks", key), "rb") as f:
        return f.read()


def test_cas_corrupt_fast_chunk_restores_via_fallthrough(tmp_path) -> None:
    """The restore heals through the durable tier; fsck --repair then
    rewrites the fast chunk, and a restore afterwards reroutes nothing."""
    from torchsnapshot_tpu_torch.fsck import repair_cas_store, verify_cas_store

    with knobs.enable_cas():
        root, fast, durable, want, mgr, key = _cas_setup(tmp_path)
        _flip_middle_byte(os.path.join(fast, "chunks", key))
        dest = {"m": TensorTreeState({"w": torch.zeros_like(want)})}
        snapshot = Snapshot(mgr.step_path(0))
        snapshot.restore(dest)
        assert torch.equal(dest["m"].tree["w"], want)
        assert snapshot.restore_telemetry["degraded_reads"]["blobs"] == 1
        assert snapshot.restore_telemetry["tier_split"].get("durable", 0) == want.numel() * 4

        assert any(p.kind == "checksum" for p in verify_cas_store(root, deep=True).problems)
        repair = repair_cas_store(root)
        assert any(key in loc for loc in repair.rewritten)
        assert not repair.quarantined
        assert verify_cas_store(root, deep=True).ok

        dest2 = {"m": TensorTreeState({"w": torch.zeros_like(want)})}
        snapshot2 = Snapshot(mgr.step_path(0))
        snapshot2.restore(dest2)
        assert torch.equal(dest2["m"].tree["w"], want)
        assert "degraded_reads" not in snapshot2.restore_telemetry


def test_cas_corrupt_durable_chunk_repaired_from_fast(tmp_path) -> None:
    """Damage on the durable tier's chunk: a plain restore does not see
    it (the fast tier serves), the per-tier deep audit does, and --repair
    rebuilds the durable copy from the fast one."""
    from torchsnapshot_tpu_torch.fsck import repair_cas_store, verify_cas_store

    with knobs.enable_cas():
        root, fast, durable, want, mgr, key = _cas_setup(tmp_path)
        _flip_middle_byte(os.path.join(durable, "chunks", key))
        pre = verify_cas_store(root, deep=True)
        assert any(p.kind == "checksum" and key in p.location for p in pre.problems)
        repair = repair_cas_store(root)
        rewritten = {loc: src for loc, src in repair.rewritten.items() if key in loc}
        assert rewritten and all(src.startswith(fast) for src in rewritten.values())
        assert verify_cas_store(root, deep=True).ok
        assert _chunk_bytes(durable, key) == _chunk_bytes(fast, key)


def test_cas_all_tiers_corrupt_quarantines_never_serves(tmp_path) -> None:
    """Every tier's copy bad: --repair quarantines each copy, the audit
    reports the dangling ref, and a restore fails loudly."""
    from torchsnapshot_tpu_torch.fsck import QUARANTINE_DIRNAME, repair_cas_store, verify_cas_store

    with knobs.enable_cas():
        root, fast, durable, want, mgr, key = _cas_setup(tmp_path)
        _flip_middle_byte(os.path.join(fast, "chunks", key))
        _flip_middle_byte(os.path.join(durable, "chunks", key))
        repair = repair_cas_store(root)
        assert repair.quarantined == [key]
        for tier in (fast, durable):
            assert os.path.exists(os.path.join(tier, "chunks", QUARANTINE_DIRNAME, key))
            assert not os.path.exists(os.path.join(tier, "chunks", key))
        post = verify_cas_store(root, deep=True)
        assert any(p.kind == "missing" and key in p.location for p in post.problems)
        dest = {"m": TensorTreeState({"w": torch.zeros_like(want)})}
        with pytest.raises(Exception):
            mgr.restore_latest(dest)
        assert not dest["m"].tree["w"].any()


def test_cross_tier_repair_of_step_local_blobs(tmp_path) -> None:
    """``fsck --repair`` of a tiered snapshot (no chunk store): a damaged
    step-local blob on one tier is rewritten from the other, and the
    deep audit of each tier then passes."""
    from torchsnapshot_tpu_torch.fsck import main as fsck_main, repair_snapshot, verify_snapshot

    root, fast, durable = _tiered_root(tmp_path)
    mgr = CheckpointManager(root)
    mgr.save(0, {"m": TensorTreeState({"w": torch.arange(20_000, dtype=torch.float32)})})
    mgr.wait_durable(0)
    _flip_middle_byte(os.path.join(durable, "step_0000000000", "0", "m", "w"))
    assert not verify_snapshot(mgr.step_path(0), deep=True, tier="durable").ok
    repair = repair_snapshot(mgr.step_path(0))
    assert repair.rewritten == {"durable:0/m/w": "cross-tier"}
    for tier in ("fast", "durable"):
        assert verify_snapshot(mgr.step_path(0), deep=True, tier=tier).ok
    assert fsck_main([mgr.step_path(0), "--repair", "--deep"]) == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda_only
def test_tiered_cuda_restore_heals_a_corrupt_fast_copy(tmp_path) -> None:
    """A tiered take and restore of CUDA leaves, one fast copy corrupt:
    the healed read verifies before its bytes go to the card, and the
    restored leaves equal the saved ones bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root, fast, durable = _tiered_root(tmp_path)
    gen = torch.Generator().manual_seed(0)
    saved = {
        "w": torch.randn(1024, 256, generator=gen).to("cuda", torch.bfloat16),
        "b": torch.randn(4096, generator=gen).cuda(),
    }
    mgr = CheckpointManager(root)
    mgr.save(0, {"m": TensorTreeState({k: v.clone() for k, v in saved.items()})})
    mgr.wait_durable(0)
    _flip_middle_byte(os.path.join(fast, "step_0000000000", "0", "m", "w"))
    dest = {"m": TensorTreeState({k: torch.zeros_like(v) for k, v in saved.items()})}
    snapshot = Snapshot(mgr.step_path(0))
    snapshot.restore(dest)
    torch.cuda.synchronize()
    for k, v in saved.items():
        got = dest["m"].tree[k]
        assert got.is_cuda and torch.equal(got.view(torch.uint8), v.view(torch.uint8)), k
    assert snapshot.restore_telemetry["degraded_reads"]["blobs"] == 1
