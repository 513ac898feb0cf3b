"""Scale-model storm harness: simulated ranks over the real code paths.

Counterpart of ``torchsnapshot_tpu/scalemodel/harness.py``, over this
package's coordination code. One simulated rank is one thread running
the SPMD program a real process would: publish its peer endpoint, then
per step run a *save storm* (path broadcast, manifest gather and commit
barrier: the ``Snapshot.take`` coordination skeleton) and a *restore
storm* (a real :class:`~torchsnapshot_tpu_torch.fanout.FanoutRestoreContext`
owner-table exchange round over mock shard blobs served by the in-memory
storage plugin, then the round barrier). A *preemption storm* kills
chosen ranks mid-round with the production ``report_error`` discipline,
and every survivor must abandon through ``BarrierError`` / ``FanoutError``
within seconds, not at the store timeout.

The device state is mocked (deterministic per-source-rank byte patterns,
verified after every exchange); the coordination is not: the storms run
the barrier, store and exchange implementations the package ships, so a
topology regression shows up here at world 256 without a cluster.

Attribution: each rank accumulates wall time per structure (collective
broadcast / gather, barrier arrive + depart, fan-out exchange, endpoint
resolve); the result holds the straggler (max) and the mean per
structure, the registry's ``coordination_*`` counter deltas over the
storm, and the store requests counted by :class:`CountingStore`. With the
fleet metrics plane on (``TORCHSNAPSHOT_TPU_FLEET_OBS=1``) each simulated
rank also publishes an ``__obs/rank/<r>`` snapshot.
"""

from __future__ import annotations

import asyncio
import dataclasses
import threading
import time
import uuid
from types import SimpleNamespace
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

from .. import dist_store, knobs, telemetry
from ..dist_store import (
    InProcessStore,
    LinearBarrier,
    ProcessGroup,
    ShardedStore,
    Store,
    StoreBarrier,
    TCPStore,
    TreeBarrier,
    lookup_endpoints,
    publish_endpoint,
)
from ..fanout import FanoutRestoreContext
from ..pg_wrapper import PGWrapper
from ..resharding import assign_shard_owners
from ..storage_plugins.memory import MemoryStoragePlugin
from ..telemetry import wire

_ENDPOINT_SERVICE = "scalemodel"


class SimulatedPreemption(RuntimeError):
    """The injected rank-death fault: raised inside a configured rank's
    round, reported into the round barrier exactly like a production
    failure (snapshot.py's ``_reporting_to`` discipline)."""


# ---------------------------------------------------------------------------
# Store adapters
# ---------------------------------------------------------------------------


class CountingStore(Store):
    """Request-counting delegate: every primitive (and every batched op,
    counted as ONE request — it is one wire round trip) bumps a per-op
    counter. The instrument behind the poll-backoff and batching
    request-count pins: correctness claims ride the real store, traffic
    claims ride these counters."""

    def __init__(self, inner: Store) -> None:
        self.inner = inner
        self.counts: Dict[str, int] = {}
        # key -> how many requests touched it (batched ops count each
        # key they carry): summed across ranks, the per-key maximum is
        # the hot-key fan-in — the O(world) wall the tree barrier
        # bounds at O(fanout) and the linear barrier concentrates on
        # its leader keys.
        self.key_touches: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _bump(self, op: str, keys) -> None:
        with self._lock:
            self.counts[op] = self.counts.get(op, 0) + 1
            for key in keys:
                self.key_touches[key] = self.key_touches.get(key, 0) + 1

    @property
    def total_requests(self) -> int:
        with self._lock:
            return sum(self.counts.values())

    def set(self, key: str, value: bytes) -> None:
        self._bump("set", (key,))
        self.inner.set(key, value)

    def try_get(self, key: str) -> Optional[bytes]:
        self._bump("try_get", (key,))
        return self.inner.try_get(key)

    def add(self, key: str, amount: int) -> int:
        self._bump("add", (key,))
        return self.inner.add(key, amount)

    def delete(self, key: str) -> None:
        self._bump("delete", (key,))
        self.inner.delete(key)

    def multi_set(self, items: Dict[str, bytes]) -> None:
        self._bump("multi_set", items.keys())
        self.inner.multi_set(items)

    def multi_get(self, keys: Sequence[str]) -> Dict[str, Optional[bytes]]:
        self._bump("multi_get", keys)
        return self.inner.multi_get(keys)

    def multi_delete(self, keys) -> None:
        keys = list(keys)
        self._bump("multi_delete", keys)
        self.inner.multi_delete(keys)


class PerKeyStore(Store):
    """Baseline adapter: exposes ONLY the four primitives, so every
    ``multi_*`` degrades to the ``Store`` base class's per-key loop —
    one round trip per key, the wire behavior before batching: the
    "per-key baseline" axis is this wrapper over the same store."""

    def __init__(self, inner: Store) -> None:
        self.inner = inner

    def set(self, key: str, value: bytes) -> None:
        self.inner.set(key, value)

    def try_get(self, key: str) -> Optional[bytes]:
        return self.inner.try_get(key)

    def add(self, key: str, amount: int) -> int:
        return self.inner.add(key, amount)

    def delete(self, key: str) -> None:
        self.inner.delete(key)


# ---------------------------------------------------------------------------
# Configuration / result
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StormConfig:
    """One storm's shape. The ``barrier``/``batched``/``store_shards``
    axes are the structures that batching, the tree barrier and sharding
    replaced: a run compares (linear, per-key, 1 shard) against (tree,
    batched, N)."""

    world_size: int
    steps: int = 1
    # Storm steps run before timing starts: absorbs thread spawn /
    # connect skew so per-structure times are steady-state coordination,
    # not harness startup (the first step's barrier IS the start skew).
    warmup_steps: int = 0
    barrier: str = "tree"  # "tree" | "linear"
    barrier_fanout: int = 16
    batched: bool = True  # False: PerKeyStore hides the multi_* ops
    store: str = "inprocess"  # "inprocess" | "tcp"
    store_shards: int = 1
    shard_bytes: int = 4096
    save_storm: bool = True
    # False strips the save storm to its commit barrier (no broadcast/
    # gather): the pure-barrier storm growth curves are measured on.
    save_collectives: bool = True
    restore_storm: bool = True
    endpoint_round: bool = True
    kill_ranks: FrozenSet[int] = frozenset()
    kill_step: int = 0
    timeout_s: float = 60.0
    count_requests: bool = True
    # The poll shape before backoff: fixed 5 ms interval instead of exponential
    # backoff. Baseline storms set it so the O(world) idle-QPS wall the
    # backoff removed stays measurable; never used in production.
    legacy_poll: bool = False


@dataclasses.dataclass
class StormResult:
    config: StormConfig
    wall_s: float
    # Per-structure wall time: straggler (max across ranks) and mean.
    max_s: Dict[str, float]
    mean_s: Dict[str, float]
    # Total store requests observed by the CountingStore wrappers.
    store_requests: int
    store_request_ops: Dict[str, int]
    # coordination_* registry counter deltas over the storm window
    # (process-global — run storms one at a time).
    counters: Dict[str, float]
    # rank -> repr(error) for every rank that raised; injected victims
    # land here alongside survivors that (correctly) aborted.
    errors: Dict[int, str]
    # Ranks whose exchanges completed with verified bytes.
    verified_ranks: int
    hung_ranks: int
    # The hottest key's fleet-wide touch count (and which key): the
    # per-key fan-in the tree barrier bounds at O(fanout) where the
    # linear barrier concentrates O(world) waiters on its leader keys.
    # ``hot_data_*`` excludes ``/error`` keys — the error channel is
    # deliberately one shared key every rank polls (poison must reach
    # everyone), so it is O(world) fan-in by design in BOTH topologies
    # and would mask the structural difference.
    hot_key_touches: int = 0
    hot_key: str = ""
    hot_data_key_touches: int = 0
    hot_data_key: str = ""

    @property
    def coordination_s(self) -> float:
        """The straggler's total coordination wall — the storm's
        headline number."""
        return sum(self.max_s.values())

    def survivors_aborted_cleanly(self) -> bool:
        """Under injected rank death: every survivor raised (abandoned)
        rather than hanging to the store timeout."""
        survivors = set(range(self.config.world_size)) - set(
            self.config.kill_ranks
        )
        return self.hung_ranks == 0 and all(
            r in self.errors for r in survivors
        )


# ---------------------------------------------------------------------------
# Mock checkpoint state
# ---------------------------------------------------------------------------


def _shard_pattern(src_rank: int, nbytes: int) -> bytes:
    """Deterministic mock shard bytes for source rank ``src_rank`` —
    what exchange verification checks slices against."""
    unit = src_rank.to_bytes(4, "little", signed=False)
    return (unit * (nbytes // 4 + 1))[:nbytes]


def _seed_blobs(
    world: int, shard_bytes: int, plugin_name: str
) -> Dict[str, Tuple[int, int]]:
    """Seed one mock saved shard blob per source rank into the shared
    in-memory plugin; returns the fan-out windows table."""
    plugin = MemoryStoragePlugin(plugin_name)
    windows: Dict[str, Tuple[int, int]] = {}
    for src in range(world):
        loc = f"step/state/w_{src}.dist"
        plugin._blobs[loc] = _shard_pattern(src, shard_bytes)
        windows[loc] = (0, shard_bytes)
    return windows


def _needs_reqs(rank: int, world: int, windows: Dict[str, Tuple[int, int]]):
    """This rank's mock read plan: its own full shard plus the second
    half of its ring neighbor's — a reshard-shaped pattern that forces
    cross-rank traffic and sub-window slicing through the exchange.
    ``FanoutRestoreContext`` only reads ``path``/``byte_range``."""
    own = f"step/state/w_{rank}.dist"
    neighbor = f"step/state/w_{(rank + 1) % world}.dist"
    lo, hi = windows[neighbor]
    half = lo + (hi - lo) // 2
    return [
        SimpleNamespace(path=own, byte_range=windows[own]),
        SimpleNamespace(path=neighbor, byte_range=(half, hi)),
    ]


def _verify_exchange(
    ctx: FanoutRestoreContext, reqs, shard_bytes: int
) -> None:
    """Every requested window must be byte-identical to the seeded
    pattern — the exchange moved real bytes, not just keys."""
    for req in reqs:
        (lo, hi), data = ctx.cache[req.path]
        a, b = req.byte_range
        src = int(req.path.rsplit("_", 1)[1].split(".")[0])
        expect = _shard_pattern(src, shard_bytes)[a:b]
        got = bytes(data[a - lo : b - lo])
        if got != expect:
            raise AssertionError(
                f"exchange corruption: {req.path}[{a}:{b}] mismatched "
                f"({len(got)} bytes vs {len(expect)} expected)"
            )


# ---------------------------------------------------------------------------
# The storm
# ---------------------------------------------------------------------------


def _build_stores(
    cfg: StormConfig,
) -> Tuple[List[Store], List[Any], List[CountingStore]]:
    """One store per simulated rank (plus the server handles to close,
    plus the wire-level counters). TCP mode gives every rank its own
    client socket(s) — the real wire contention profile; in-process
    mode shares lock-guarded dicts — the protocol-only profile fast
    enough for 1000 ranks in a unit test.

    Counting wraps each WIRE client (i.e. every ShardedStore member
    individually, below the routing layer): a batched op that touches
    two shards costs two wire round trips and must be charged as two —
    counting above the router would undercount exactly the tuned
    sharded configs a comparison is about."""
    closers: List[Any] = []
    counters: List[CountingStore] = []

    def counted(wire: Store) -> Store:
        if not cfg.count_requests:
            return wire
        counter = CountingStore(wire)
        counters.append(counter)
        return counter

    if cfg.store == "tcp":
        servers = []
        for _ in range(max(1, cfg.store_shards)):
            srv = TCPStore("127.0.0.1", 0, is_server=True)
            servers.append(srv)
            closers.append(srv)
        stores: List[Store] = []
        for _ in range(cfg.world_size):
            clients = []
            for srv in servers:
                client = TCPStore("127.0.0.1", srv.port, is_server=False)
                closers.append(client)
                clients.append(counted(client))
            stores.append(
                clients[0] if len(clients) == 1 else ShardedStore(clients)
            )
        return stores, closers, counters
    if cfg.store_shards > 1:
        shared: Store = ShardedStore(
            [counted(InProcessStore()) for _ in range(cfg.store_shards)]
        )
    else:
        shared = counted(InProcessStore())
    return [shared] * cfg.world_size, closers, counters


def _make_barrier(
    cfg: StormConfig, prefix: str, store: Store, rank: int
) -> StoreBarrier:
    if cfg.barrier == "linear":
        return LinearBarrier(prefix, store, rank, cfg.world_size)
    return TreeBarrier(
        prefix, store, rank, cfg.world_size, fanout=cfg.barrier_fanout
    )


def _rank_program(
    cfg: StormConfig,
    rank: int,
    store: Store,
    windows: Dict[str, Tuple[int, int]],
    owners: Dict[str, int],
    plugin_name: str,
    timers: Dict[str, float],
    out: Dict[str, Any],
) -> None:
    pg = PGWrapper(
        ProcessGroup(store=store, rank=rank, world_size=cfg.world_size)
    )
    plugin = MemoryStoragePlugin(plugin_name)
    loop = asyncio.new_event_loop()
    # The fleet metrics plane (knob-gated, default off): each simulated
    # rank publishes a bounded wire-health snapshot under __obs/, so that
    # ``python -m torchsnapshot_tpu_torch.telemetry fleet`` renders a
    # live per-rank table of a running storm.
    fleet: Optional[wire.FleetReporter] = None
    if knobs.is_fleet_obs_enabled():
        fleet = wire.FleetReporter(
            store, "rank", str(rank), world=cfg.world_size
        )
    try:
        if cfg.endpoint_round:
            publish_endpoint(
                store, _ENDPOINT_SERVICE, rank, "sim-host", 40000 + rank
            )
        for step in range(cfg.warmup_steps + cfg.steps):
            if step == cfg.warmup_steps:
                for k in list(timers):
                    timers[k] = 0.0
            if fleet is not None:
                try:
                    fleet.publish(phase=f"step:{step}")
                except Exception:  # noqa: BLE001 - never stalls the storm
                    pass
            if cfg.save_storm:
                # The Snapshot.take coordination skeleton: one path/nonce
                # broadcast, the manifest gather to rank 0, the commit
                # barrier.
                if cfg.save_collectives:
                    t0 = time.perf_counter()
                    pg.broadcast_object(f"step_{step}")
                    pg.gather_object({"rank": rank, "entries": 1})
                    timers["collective_s"] += time.perf_counter() - t0
                barrier = _make_barrier(
                    cfg, f"__storm/{step}/commit", store, rank
                )
                t0 = time.perf_counter()
                barrier.arrive(cfg.timeout_s)
                barrier.depart(cfg.timeout_s)
                timers["barrier_s"] += time.perf_counter() - t0
            if cfg.restore_storm:
                prefix = f"__storm/{step}/restore"
                barrier = _make_barrier(cfg, prefix, store, rank)
                ctx = FanoutRestoreContext(
                    owners, windows, store, rank, cfg.world_size
                )
                reqs = _needs_reqs(rank, cfg.world_size, windows)
                try:
                    if rank in cfg.kill_ranks and step == cfg.kill_step:
                        raise SimulatedPreemption(
                            f"rank {rank} preempted at step {step}"
                        )
                    t0 = time.perf_counter()
                    ctx.exchange(
                        reqs,
                        plugin,
                        loop,
                        rendezvous_prefix=prefix,
                        timeout=cfg.timeout_s,
                    )
                    timers["exchange_s"] += time.perf_counter() - t0
                    _verify_exchange(ctx, reqs, cfg.shard_bytes)
                    out["verified"] = out.get("verified", 0) + 1
                except BaseException as e:
                    # The production _reporting_to discipline: poison
                    # the round barrier so peers abandon in seconds.
                    try:
                        barrier.report_error(e)
                    except Exception:  # noqa: BLE001 - already failing
                        pass
                    raise
                finally:
                    ctx.clear()
                t0 = time.perf_counter()
                barrier.arrive(cfg.timeout_s)
                barrier.depart(cfg.timeout_s)
                timers["barrier_s"] += time.perf_counter() - t0
        if cfg.endpoint_round:
            # Restore-setup shape: resolve EVERY rank's endpoint (one
            # batched round trip on a batched store; world sequential
            # lookups through PerKeyStore — the measured difference).
            t0 = time.perf_counter()
            endpoints = lookup_endpoints(
                store, _ENDPOINT_SERVICE, range(cfg.world_size)
            )
            timers["endpoint_s"] += time.perf_counter() - t0
            if not cfg.kill_ranks and len(endpoints) != cfg.world_size:
                raise AssertionError(
                    f"rank {rank}: resolved {len(endpoints)} of "
                    f"{cfg.world_size} endpoints"
                )
    finally:
        if fleet is not None:
            try:
                fleet.close()
            except Exception:  # noqa: BLE001
                pass
        loop.close()


def run_storm(cfg: StormConfig) -> StormResult:
    """Run one storm to completion and attribute it. Never raises for
    per-rank failures (they land in ``result.errors``); raises only for
    harness-level misuse."""
    if cfg.world_size < 1:
        raise ValueError("world_size must be >= 1")
    plugin_name = f"scalemodel-{uuid.uuid4().hex}"
    windows = _seed_blobs(cfg.world_size, cfg.shard_bytes, plugin_name)
    owners = assign_shard_owners(windows, cfg.world_size)
    # Counting sits at the WIRE (inside _build_stores, per shard
    # member): a PerKeyStore above fans every multi_* into per-key
    # requests and the baseline is charged for exactly that traffic; a
    # sharded batch is charged one request per touched shard.
    stores, closers, counters = _build_stores(cfg)
    rank_stores: List[Store] = [
        s if cfg.batched else PerKeyStore(s) for s in stores
    ]

    timers: List[Dict[str, float]] = [
        {"collective_s": 0.0, "barrier_s": 0.0, "exchange_s": 0.0,
         "endpoint_s": 0.0}
        for _ in range(cfg.world_size)
    ]
    outs: List[Dict[str, Any]] = [{} for _ in range(cfg.world_size)]
    errors: Dict[int, str] = {}
    errors_lock = threading.Lock()

    def _run(rank: int) -> None:
        try:
            _rank_program(
                cfg,
                rank,
                rank_stores[rank],
                windows,
                owners,
                plugin_name,
                timers[rank],
                outs[rank],
            )
        except BaseException as e:  # noqa: BLE001 - recorded, not raised
            with errors_lock:
                errors[rank] = repr(e)

    counter_baseline = telemetry.metrics().counters_snapshot()
    threads = [
        threading.Thread(
            target=_run, args=(r,), name=f"simrank-{r}", daemon=True
        )
        for r in range(cfg.world_size)
    ]
    prev_profile = None
    if cfg.legacy_poll:
        prev_profile = dist_store._set_poll_profile(0.005, 0.005)
    t_start = time.perf_counter()
    try:
        for t in threads:
            t.start()
        join_deadline = time.monotonic() + cfg.timeout_s + 30.0
        hung = 0
        for t in threads:
            t.join(timeout=max(0.1, join_deadline - time.monotonic()))
            if t.is_alive():
                hung += 1
        wall_s = time.perf_counter() - t_start
    finally:
        if prev_profile is not None:
            dist_store._set_poll_profile(*prev_profile)
    deltas = telemetry.metrics().counters_delta_since(counter_baseline)
    coord_counters = {
        k: round(v, 6)
        for k, v in deltas.items()
        if k.startswith("coordination_")
    }

    try:
        MemoryStoragePlugin.drop_store(plugin_name)
    finally:
        for c in closers:
            try:
                c.close()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass

    structures = ("collective_s", "barrier_s", "exchange_s", "endpoint_s")
    max_s = {
        k: round(max(t[k] for t in timers), 6) for k in structures
    }
    mean_s = {
        k: round(sum(t[k] for t in timers) / cfg.world_size, 6)
        for k in structures
    }
    request_ops: Dict[str, int] = {}
    key_touches: Dict[str, int] = {}
    for c in counters:
        for op, n in c.counts.items():
            request_ops[op] = request_ops.get(op, 0) + n
        for key, n in c.key_touches.items():
            key_touches[key] = key_touches.get(key, 0) + n
    hot_key, hot_touches = "", 0
    hot_data_key, hot_data_touches = "", 0
    for key, n in key_touches.items():
        if n > hot_touches:
            hot_key, hot_touches = key, n
        if n > hot_data_touches and not key.endswith("/error"):
            hot_data_key, hot_data_touches = key, n
    return StormResult(
        config=cfg,
        wall_s=round(wall_s, 6),
        max_s=max_s,
        mean_s=mean_s,
        store_requests=sum(request_ops.values()),
        store_request_ops=request_ops,
        hot_key_touches=hot_touches,
        hot_key=hot_key,
        hot_data_key_touches=hot_data_touches,
        hot_data_key=hot_data_key,
        counters=coord_counters,
        errors=errors,
        verified_ranks=sum(o.get("verified", 0) > 0 for o in outs),
        hung_ranks=hung,
    )
