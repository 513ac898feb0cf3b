"""The port's coordination store: TCP store primitives, object
collectives, the linear and tree barriers, the poll backoff, and the
``torch.distributed`` bootstrap.

Port of the JAX package's ``tests/test_dist_store.py``. Its two
``jax_process_group`` cases become ``torch_process_group`` cases over a
c10d store (a ``HashStore`` in threads, and real ``gloo`` groups and
torchrun's environment in spawned processes). Results are compared
exactly; timing bounds are the JAX file's.
"""

import threading
import time

import pytest

from torchsnapshot_tpu_torch.dist_store import (
    BarrierError,
    InProcessStore,
    LinearBarrier,
    StoreTimeoutError,
    TCPStore,
)
from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
from torchsnapshot_tpu_torch.test_utils import (
    ProcessGroup,
    get_free_port,
    multiprocess_test,
    run_multiprocess,
)


class CountingStore(InProcessStore):
    """Counts requests per op (a batched op is one request: one round
    trip)."""

    def __init__(self, inner: InProcessStore) -> None:
        super().__init__()
        self.inner = inner
        self.counts = {}

    def _bump(self, op: str) -> None:
        self.counts[op] = self.counts.get(op, 0) + 1

    def set(self, key, value):
        self._bump("set")
        self.inner.set(key, value)

    def try_get(self, key):
        self._bump("try_get")
        return self.inner.try_get(key)

    def add(self, key, amount):
        self._bump("add")
        return self.inner.add(key, amount)

    def delete(self, key):
        self._bump("delete")
        self.inner.delete(key)

    def multi_get(self, keys):
        self._bump("multi_get")
        return self.inner.multi_get(keys)


def test_tcp_store_primitives() -> None:
    port = get_free_port()
    server = TCPStore("127.0.0.1", port, is_server=True)
    client = TCPStore("127.0.0.1", server.port, is_server=False)
    try:
        server.set("k", b"v")
        assert client.try_get("k") == b"v"
        assert client.try_get("missing") is None
        assert client.add("ctr", 3) == 3
        assert server.add("ctr", 2) == 5
        client.delete("k")
        assert server.try_get("k") is None
        with pytest.raises(StoreTimeoutError):
            client.get("never", timeout=0.2)
    finally:
        client.close()
        server.close()


def test_store_collectives_threads() -> None:
    """Exercise exchange/broadcast/scatter/barrier with threads sharing one
    in-process store."""
    store = InProcessStore()
    world = 3
    results = {}

    def worker(rank: int) -> None:
        pg = PGWrapper(ProcessGroup(store=store, rank=rank, world_size=world))
        results[(rank, "ag")] = pg.all_gather_object(f"obj{rank}")
        results[(rank, "bc")] = pg.broadcast_object(
            "from0" if rank == 0 else None
        )
        results[(rank, "sc")] = pg.scatter_object_list(
            [f"to{i}" for i in range(world)] if rank == 0 else None
        )
        pg.barrier()

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for r in range(world):
        assert results[(r, "ag")] == ["obj0", "obj1", "obj2"]
        assert results[(r, "bc")] == "from0"
        assert results[(r, "sc")] == f"to{r}"
    # Collective keys are transient: nothing should linger.
    assert store._kv == {}


def test_gather_object_to_leader_threads() -> None:
    """gather: dst receives rank-ordered blobs, others receive None, the
    dst's own blob never touches the store, and keys are cleaned up."""
    store = InProcessStore()
    world = 3
    results = {}
    set_keys = []
    orig_set = store.set

    def spying_set(key, value):
        set_keys.append(key)
        orig_set(key, value)

    store.set = spying_set

    def worker(rank: int) -> None:
        pg = PGWrapper(ProcessGroup(store=store, rank=rank, world_size=world))
        results[rank] = pg.gather_object({"rank": rank})

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert results[0] == [{"rank": 0}, {"rank": 1}, {"rank": 2}]
    assert results[1] is None and results[2] is None
    assert store._kv == {}  # transient keys cleaned
    # Only non-destination ranks published blobs (suffixes /1 and /2).
    gather_sets = [k for k in set_keys if "/ga/" in k]
    assert sorted(k.rsplit("/", 1)[1] for k in gather_sets) == ["1", "2"]


class _FlakyStore(InProcessStore):
    """Raises on the first ``fail_first_n`` reads, then recovers."""

    def __init__(self, fail_first_n: int) -> None:
        super().__init__()
        self.fails_left = fail_first_n
        self.raised = 0

    def try_get(self, key):
        if self.fails_left > 0:
            self.fails_left -= 1
            self.raised += 1
            raise ConnectionError("simulated transport hiccup")
        return super().try_get(key)


class _DeadStore(InProcessStore):
    def try_get(self, key):
        raise ConnectionError("store is gone")


def test_get_rides_out_transient_read_failures() -> None:
    """try_get raising means "could not observe", not "absent"; the
    deadline-bounded helpers retry through brief failures."""
    store = _FlakyStore(fail_first_n=3)
    store.set("k", b"v")
    assert store.get("k", timeout=5.0) == b"v"
    assert store.raised == 3


def test_get_reraises_on_persistently_dead_store() -> None:
    """A store failing continuously must re-raise after the short grace,
    not be polled until the full deadline (a dead TCPStore socket means
    the leader is gone)."""
    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        _DeadStore().get("k", timeout=60.0)
    assert time.monotonic() - t0 < 30.0  # grace, not the 60s deadline


def test_barrier_tolerates_transient_read_failures() -> None:
    """A momentary store error inside a barrier wait must not abort the
    commit barrier."""
    store = _FlakyStore(fail_first_n=2)
    world = 2
    errors = []

    def worker(rank: int) -> None:
        try:
            b = LinearBarrier("b", store, rank=rank, world_size=world)
            b.arrive(timeout=30.0)
            b.depart(timeout=30.0)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert store.raised == 2  # the hiccups actually happened


def test_linear_barrier_happy_path() -> None:
    store = InProcessStore()
    world = 3
    order = []

    def worker(rank: int) -> None:
        b = LinearBarrier("test", store, rank, world)
        b.arrive(timeout=10)
        order.append(rank)
        b.depart(timeout=10)

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert sorted(order) == [0, 1, 2]
    assert store._kv == {}  # cleaned up after depart


def test_linear_barrier_error_propagation() -> None:
    """A peer's report_error poisons every other rank's wait — no rank may
    proceed to commit (reference dist_store.py:177-193)."""
    store = InProcessStore()
    world = 2
    caught = {}

    def rank0() -> None:
        b = LinearBarrier("err", store, 0, world)
        try:
            b.arrive(timeout=10)
        except BarrierError as e:
            caught[0] = e

    def rank1() -> None:
        b = LinearBarrier("err", store, 1, world)
        time.sleep(0.05)
        b.report_error(RuntimeError("injected rank-1 failure"))

    threads = [threading.Thread(target=rank0), threading.Thread(target=rank1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert 0 in caught
    assert "injected rank-1 failure" in repr(caught[0].__cause__)


def test_linear_barrier_timeout() -> None:
    store = InProcessStore()
    b = LinearBarrier("t", store, 0, 2)  # peer never arrives
    with pytest.raises(StoreTimeoutError):
        b.arrive(timeout=0.2)


def test_barrier_depart_requires_arrive() -> None:
    b = LinearBarrier("x", InProcessStore(), 0, 1)
    with pytest.raises(RuntimeError, match="before arrive"):
        b.depart()


@multiprocess_test(nproc=2)
def test_collectives_across_processes(pg) -> None:
    wrapper = PGWrapper(pg)
    gathered = wrapper.all_gather_object({"rank": pg.rank})
    assert gathered == [{"rank": 0}, {"rank": 1}]
    assert wrapper.broadcast_object("x" if pg.rank == 0 else None) == "x"
    wrapper.barrier()


def test_world_32_stress_over_tcp() -> None:
    """Scale check for the coordination layer: 32 ranks
    — each with its own TCP client connection — run LinearBarrier
    arrive/depart, a manifest-sized exchange, and a counter barrier, and
    the whole thing completes in seconds. The leader's waits are single
    counter-key polls and exchange is a rank-0 aggregate + one fetch per
    rank, so wall time stays flat-ish in world size."""
    world = 32
    server = TCPStore("127.0.0.1", 0, is_server=True)
    payload = {"manifest": ["0/model/layer/%d" % i for i in range(200)]}
    results: dict = {}
    errors: list = []

    def worker(rank: int) -> None:
        client = (
            server
            if rank == 0
            else TCPStore("127.0.0.1", server.port, is_server=False)
        )
        try:
            pg = PGWrapper(
                ProcessGroup(store=client, rank=rank, world_size=world)
            )
            gathered = pg.all_gather_object({**payload, "rank": rank})
            assert [g["rank"] for g in gathered] == list(range(world))
            barrier = LinearBarrier(
                "stress32", client, rank=rank, world_size=world
            )
            barrier.arrive(timeout=60)
            barrier.depart(timeout=60)
            pg.barrier()
            results[rank] = True
        except Exception as e:  # noqa: BLE001
            errors.append((rank, e))
        finally:
            if rank != 0:
                client.close()

    t0 = time.monotonic()
    threads = [
        threading.Thread(target=worker, args=(r,)) for r in range(world)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    elapsed = time.monotonic() - t0
    server.close()
    assert not errors, errors[:3]
    assert len(results) == world
    assert elapsed < 60, f"world-32 coordination took {elapsed:.1f}s"


def test_torch_pg_bootstraps_tcp_store_over_c10d(monkeypatch) -> None:
    """torch_process_group's bootstrap: the package's TCPStore is set up
    through the c10d store with set/get only (rank 0 hosts it and
    publishes its address, the others read it)."""
    import torch.distributed as dist

    from torchsnapshot_tpu_torch.dist_store import C10dStore, _bootstrap_tcp_store

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    kv = C10dStore(dist.HashStore())
    assert kv.try_get("absent") is None
    stores = {}

    def worker(rank: int) -> None:
        stores[rank] = _bootstrap_tcp_store(kv, rank, timeout=30)

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert sorted(stores) == [0, 1, 2]
    try:
        stores[0].set("k", b"v")
        assert stores[1].try_get("k") == b"v"
        assert stores[2].add("c", 5) == 5
        assert stores[1].add("c", 1) == 6
    finally:
        for s in stores.values():
            s.close()


def test_world_32_snapshot_take_restore(tmp_path) -> None:
    """Full Snapshot.take + restore at world 32 over one TCP store: the
    manifest gather (rank-0 aggregate exchange), replicated verification,
    partitioning, commit barrier — every coordination round at a pod-ish
    world size, in seconds."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState

    world = 32
    server = TCPStore("127.0.0.1", 0, is_server=True)
    path = str(tmp_path / "snap")
    errors: list = []

    def worker(rank: int) -> None:
        client = (
            server
            if rank == 0
            else TCPStore("127.0.0.1", server.port, is_server=False)
        )
        try:
            pg = ProcessGroup(store=client, rank=rank, world_size=world)
            state = {"w": torch.full((64,), float(rank)), "r": rank}
            Snapshot.take(path, {"s": TensorTreeState(state)}, pg=pg)
            dst = {"w": torch.zeros(64), "r": -1}
            wrapped = TensorTreeState(dst)
            Snapshot(path, pg=pg).restore({"s": wrapped})
            assert torch.equal(wrapped.tree["w"], torch.full((64,), float(rank)))
            assert wrapped.tree["r"] == rank
        except Exception as e:  # noqa: BLE001
            errors.append((rank, repr(e)))
        finally:
            if rank != 0:
                client.close()

    t0 = time.monotonic()
    threads = [
        threading.Thread(target=worker, args=(r,)) for r in range(world)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    elapsed = time.monotonic() - t0
    server.close()
    assert not errors, errors[:3]
    assert elapsed < 120, f"world-32 take+restore took {elapsed:.1f}s"


def test_torch_process_group_is_cached(monkeypatch) -> None:
    """Repeated torch_process_group() calls return the same ProcessGroup
    (same store object): op-seq namespaces stay shared, and no second
    server is bootstrapped under the same address key."""
    import torch.distributed as dist

    import torchsnapshot_tpu_torch.dist_store as ds

    monkeypatch.setattr(ds, "_TORCH_PG", None)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    calls = []

    def coordinates():
        calls.append(1)
        return dist.HashStore(), 0, 1

    monkeypatch.setattr(ds, "_c10d_coordinates", coordinates)
    pg1 = ds.torch_process_group()
    pg2 = ds.torch_process_group()
    try:
        assert pg1 is pg2 and len(calls) == 1
        assert (pg1.rank, pg1.world_size) == (0, 1)
        assert isinstance(pg1.store, TCPStore)
    finally:
        pg1.store.close()
        monkeypatch.setattr(ds, "_TORCH_PG", None)


def _gloo_worker(pg, port: int, use_env: bool, root: str):
    """A rank of a torch.distributed job: an initialized gloo group, or
    torchrun's environment alone; the harness's own store is unused."""
    import os

    import torch
    import torch.distributed as dist

    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, torch_process_group

    if use_env:
        os.environ.update(
            RANK=str(pg.rank), WORLD_SIZE=str(pg.world_size),
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
        )
    else:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=pg.rank,
            world_size=pg.world_size,
        )
    try:
        tpg = torch_process_group()
        assert torch_process_group() is tpg
        wrapper = PGWrapper(tpg)
        gathered = wrapper.all_gather_object(tpg.rank)
        state = {"m": TensorTreeState({"w": torch.arange(64.0), "r": torch.full((4,), float(tpg.rank))})}
        Snapshot.take(root, state, pg=tpg, replicated=["m/w"])
        dst = {"m": TensorTreeState({"w": torch.zeros(64), "r": torch.zeros(4)})}
        Snapshot(root, pg=tpg).restore(dst)
        assert torch.equal(dst["m"].tree["w"], torch.arange(64.0))
        assert torch.equal(dst["m"].tree["r"], torch.full((4,), float(tpg.rank)))
        wrapper.barrier()
        return (tpg.rank, tpg.world_size, gathered)
    finally:
        if not use_env:
            dist.destroy_process_group()


@pytest.mark.parametrize("use_env", [False, True], ids=["init-process-group", "torchrun-env"])
def test_torch_process_group_across_processes(tmp_path, use_env: bool) -> None:
    """Two processes of a torch.distributed job (a gloo default group, or
    torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT alone) get
    their ranks from torch and coordinate a take and restore through
    the bootstrapped store."""
    port = get_free_port()
    harness_port = get_free_port()
    while harness_port == port:
        harness_port = get_free_port()
    results = run_multiprocess(
        _gloo_worker, nproc=2, args=(port, use_env, str(tmp_path / "snap")), port=harness_port
    )
    assert results == [(0, 2, [0, 1]), (1, 2, [0, 1])]


def test_tcp_store_connect_timeout_is_a_clear_error() -> None:
    """A client whose rank-0 store server never comes up must fail with
    a deadline-bounded StoreTimeoutError naming the address — not a raw
    ECONNREFUSED escaping from deep inside a collective."""
    port = get_free_port()  # freed immediately: nothing listens on it
    client = TCPStore(
        "127.0.0.1", port, is_server=False, connect_timeout=0.3
    )
    t0 = time.monotonic()
    with pytest.raises(StoreTimeoutError, match="Timed out connecting"):
        client.try_get("anything")
    assert time.monotonic() - t0 < 10.0


# ---------------------------------------------------------------------------
# Batched store ops (multi_set / multi_get / multi_delete)
# ---------------------------------------------------------------------------


def test_tcp_store_multi_ops_roundtrip() -> None:
    """The batched wire commands: one frame each way per BATCH, same
    semantics as the per-key primitives (absent keys -> None)."""
    server = TCPStore("127.0.0.1", 0, is_server=True)
    client = TCPStore("127.0.0.1", server.port, is_server=False)
    try:
        client.multi_set({"a": b"1", "b": b"2", "c": b"3"})
        assert server.try_get("b") == b"2"
        got = client.multi_get(["a", "b", "missing"])
        assert got == {"a": b"1", "b": b"2", "missing": None}
        client.multi_delete(["a", "c", "never-existed"])
        assert client.multi_get(["a", "b", "c"]) == {
            "a": None,
            "b": b"2",
            "c": None,
        }
    finally:
        client.close()
        server.close()


def test_sharded_store_routing_and_collectives() -> None:
    """Deterministic key->shard routing (every client agrees), per-key
    atomicity for counters, and the base-class collectives running
    unchanged over the sharded store."""
    from torchsnapshot_tpu_torch.dist_store import ShardedStore, shard_for_key

    members = [InProcessStore() for _ in range(3)]
    store = ShardedStore(members)
    keys = [f"k{i}" for i in range(30)]
    store.multi_set({k: k.encode() for k in keys})
    # Every key lives on exactly its hashed member, nowhere else.
    for k in keys:
        shard = shard_for_key(k, 3)
        assert members[shard].try_get(k) == k.encode()
        for other in range(3):
            if other != shard:
                assert members[other].try_get(k) is None
    assert store.multi_get(keys) == {k: k.encode() for k in keys}
    assert store.add("ctr", 2) == 2 and store.add("ctr", 3) == 5
    store.multi_delete(keys[:15])
    assert store.try_get(keys[0]) is None
    assert store.try_get(keys[20]) == keys[20].encode()

    world, results = 3, {}

    def worker(rank: int) -> None:
        pg = PGWrapper(ProcessGroup(store=store, rank=rank, world_size=world))
        results[(rank, "ag")] = pg.all_gather_object(rank)
        pg.barrier()

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results[(1, "ag")] == [0, 1, 2]


# ---------------------------------------------------------------------------
# TreeBarrier
# ---------------------------------------------------------------------------


def _run_barrier_world(make, world: int):
    errors = {}

    def worker(rank: int) -> None:
        try:
            b = make(rank)
            b.arrive(timeout=10.0)
            b.depart(timeout=10.0)
        except Exception as e:  # noqa: BLE001 - collected for asserts
            errors[rank] = e

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return errors


def test_tree_barrier_happy_path_and_cleanup() -> None:
    from torchsnapshot_tpu_torch.dist_store import TreeBarrier

    store = InProcessStore()
    errors = _run_barrier_world(
        lambda r: TreeBarrier("tb", store, r, 9, fanout=2), world=9
    )
    assert errors == {}
    # Transient keys cleaned up: each rank deletes its own node keys,
    # the root the error key — a long-lived store must not accumulate.
    assert store._kv == {}


def test_tree_barrier_error_propagation() -> None:
    """report_error poisons every pending wait with BarrierError — the
    same contract LinearBarrier pins (the swap must be transparent to
    snapshot.py/fanout.py call sites)."""
    from torchsnapshot_tpu_torch.dist_store import TreeBarrier

    store = InProcessStore()
    world = 7
    errors = {}
    release = threading.Event()

    def worker(rank: int) -> None:
        b = TreeBarrier("err", store, rank, world, fanout=2)
        try:
            if rank == 3:
                release.wait(5.0)
                b.report_error(ValueError("rank 3 exploded"))
                return
            b.arrive(timeout=10.0)
            b.depart(timeout=10.0)
        except Exception as e:  # noqa: BLE001
            errors[rank] = e

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    release.set()
    for t in threads:
        t.join()
    assert set(errors) == set(range(world)) - {3}
    for e in errors.values():
        assert isinstance(e, BarrierError)
        assert isinstance(e.__cause__, ValueError)


def test_tree_barrier_timeout_and_depart_guard() -> None:
    from torchsnapshot_tpu_torch.dist_store import TreeBarrier

    b = TreeBarrier("t", InProcessStore(), 0, 2, fanout=4)
    with pytest.raises(StoreTimeoutError):
        b.arrive(timeout=0.2)
    b2 = TreeBarrier("t2", InProcessStore(), 0, 2, fanout=4)
    with pytest.raises(RuntimeError, match="depart"):
        b2.depart()


def test_tree_barrier_world_one_is_a_noop() -> None:
    from torchsnapshot_tpu_torch.dist_store import TreeBarrier

    b = TreeBarrier("solo", InProcessStore(), 0, 1, fanout=4)
    b.arrive(timeout=1.0)
    b.depart(timeout=1.0)


def test_make_barrier_honors_kill_switch() -> None:
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.dist_store import (
        LinearBarrier as _Linear,
        TreeBarrier as _Tree,
        make_barrier,
    )

    store = InProcessStore()
    assert isinstance(make_barrier("p", store, 0, 4), _Tree)
    with knobs.disable_tree_barrier():
        assert isinstance(make_barrier("p", store, 0, 4), _Linear)
    with knobs.override_barrier_fanout(5):
        assert make_barrier("p", store, 0, 4).fanout == 5


# ---------------------------------------------------------------------------
# Poll backoff (satellite: request-count reduction while waiting)
# ---------------------------------------------------------------------------


def test_wait_loops_back_off_exponentially() -> None:
    """A follower parked in a barrier wait must poll at backed-off
    intervals, not a fixed 5 ms tick: ~0.6 s of waiting costs a
    bounded handful of requests (fixed-interval polling would issue
    ~120). Pinned through the counting store, world 256 so the scaled
    cap is at its ceiling."""
    inner = InProcessStore()
    store = CountingStore(inner)
    barrier = LinearBarrier("bo", store, rank=1, world_size=256)

    def release_late() -> None:
        time.sleep(0.6)
        inner.set("bo/arrive/go", b"1")

    t = threading.Thread(target=release_late)
    t.start()
    barrier.arrive(timeout=10.0)
    t.join()
    # add(count) + N batched polls of [error, go]; exponential backoff
    # capped at 100 ms bounds N to ~12 for a 0.6 s wait.
    assert store.counts["multi_get"] <= 20
    assert store.counts["multi_get"] >= 3


def test_store_get_backs_off_but_stays_deadline_accurate() -> None:
    inner = InProcessStore()
    store = CountingStore(inner)

    def set_late() -> None:
        time.sleep(0.4)
        inner.set("late", b"v")

    t = threading.Thread(target=set_late)
    t.start()
    assert store.get("late", timeout=10.0) == b"v"
    t.join()
    assert store.counts["try_get"] <= 15
    with pytest.raises(StoreTimeoutError):
        store.get("never", timeout=0.3)


def test_wait_any_returns_what_is_present() -> None:
    """wait_any blocks until one of the keys exists and returns every
    present one; it times out with StoreTimeoutError."""
    store = InProcessStore()

    def set_late() -> None:
        time.sleep(0.2)
        store.multi_set({"b": b"2", "c": b"3"})

    t = threading.Thread(target=set_late)
    t.start()
    got = store.wait_any(["a", "b", "c"], timeout=10.0)
    t.join(timeout=10)
    assert got == {"b": b"2", "c": b"3"}
    with pytest.raises(StoreTimeoutError):
        store.wait_any(["never"], timeout=0.2)


def test_bootstrap_sharded_store_over_tcp(monkeypatch) -> None:
    """Rank 0's shard count decides for the job; shard i is hosted by rank
    i % world; every rank's ShardedStore routes a key to the same member,
    so a key set on one rank is read on another."""
    import torchsnapshot_tpu_torch.dist_store as ds

    monkeypatch.setattr(ds, "_local_advertise_host", lambda: "127.0.0.1")
    base = InProcessStore()
    world = 3
    stores = {}

    def worker(rank: int) -> None:
        # Only rank 0's count counts: the others ask for something else.
        stores[rank] = ds.bootstrap_sharded_store(base, rank, world, num_shards=4 if rank == 0 else 7)

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    try:
        assert sorted(stores) == [0, 1, 2]
        assert all(isinstance(s, ds.ShardedStore) for s in stores.values())
        keys = {f"k{i}": str(i).encode() for i in range(20)}
        stores[1].multi_set(keys)
        assert stores[2].multi_get(list(keys)) == keys
        assert stores[0].add("ctr", 2) == 2 and stores[2].add("ctr", 1) == 3
        results = {}

        def collective(rank: int) -> None:
            pg = PGWrapper(ProcessGroup(store=stores[rank], rank=rank, world_size=world))
            results[rank] = pg.all_gather_object(rank)

        threads = [threading.Thread(target=collective, args=(r,)) for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert results == {r: [0, 1, 2] for r in range(world)}
    finally:
        for s in stores.values():
            s.close()
    # One shard (the default) keeps the base store.
    solo = InProcessStore()
    assert ds.bootstrap_sharded_store(solo, 0, 2, num_shards=1) is solo


def test_store_requests_feed_the_coordination_counters() -> None:
    """Every TCP store round trip adds one request and its seconds to the
    ``coordination_store_*`` counters, labelled by op; a barrier adds its
    wait to ``coordination_barrier_wait_seconds_total``."""
    from torchsnapshot_tpu_torch import telemetry
    from torchsnapshot_tpu_torch.telemetry import names

    def counters():
        return telemetry.metrics().counters_snapshot()

    server = TCPStore("127.0.0.1", 0, is_server=True)
    try:
        before = counters()
        server.set("k", b"v")
        server.try_get("k")
        server.multi_get(["k", "absent"])
        LinearBarrier("solo", server, 0, 1).arrive(timeout=5.0)
        after = counters()
    finally:
        server.close()

    def delta(key: str) -> float:
        return after.get(key, 0.0) - before.get(key, 0.0)

    for op in ("set", "try_get", "multi_get"):
        assert delta(f'{names.COORD_STORE_REQUESTS_TOTAL}{{op="{op}"}}') >= 1, op
        assert delta(f'{names.COORD_STORE_SECONDS_TOTAL}{{op="{op}"}}') > 0, op
    assert delta(f'{names.COORD_BARRIER_WAIT_SECONDS_TOTAL}{{impl="linear",phase="arrive"}}') > 0
