"""The serving fleet's side of the CDN: track a topic, pull novel chunks.

Counterpart of ``torchsnapshot_tpu/cdn/subscriber.py``. Each subscriber
runs the peer tier's cache server (``tiered/peer.py``: length-prefixed
frames, chunks pooled by key; a server of either package answers a client
of the other) and advertises it in the ``cdn-fleet`` endpoint registry.
On a new announce it diffs the announced chunk set against what it holds
and fetches only the novel chunks, in two tiers:

- **owner**: ``resharding.assign_shard_owners`` elects one subscriber per
  chunk (deterministic over the novel set, so every member computes the
  same table without coordination); the owner reads the chunk from
  durable storage once and pools it.
- **everyone else** pulls the chunk from its owner's server, backing off
  with the world-scaled poll pacer until the owner holds it, and reads
  durable storage only after the pull-timeout knob expires (a dead owner
  costs extra durable reads, never a stuck fleet).

Every accepted byte, peer or durable, is verified against the chunk key's
embedded digest before it is pooled or swapped in: a fleet of N
subscribers costs about one durable read per novel chunk, not N.

With ``root`` (the training job's manager root), each applied step posts
``cdn-swapped`` to that root's run ledger, as the JAX package does. A sync
round runs inside one ``wire.propagate(RPC_CDN_SYNC)``, so each peer pull
of the round carries the round's trace id; with the fleet metrics plane
on (``TORCHSNAPSHOT_TPU_FLEET_OBS=1``) the subscriber keeps one
``__obs/subscriber/<id>`` snapshot, refreshed per applied step and reaped
by :meth:`CdnSubscriber.close`.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from .. import knobs, telemetry
from ..cas import chunk_location
from ..chaos import crashpoint
from ..dist_store import Store, _PollPacer, lookup_endpoints, publish_endpoint, scaled_poll_cap
from ..resharding import assign_shard_owners
from ..scheduler import PeerCacheBudget
from ..telemetry import ledger
from ..telemetry import names as metric_names
from ..telemetry import wire
from ..telemetry.trace import get_recorder as _trace_recorder
from ..tiered.peer import PeerCache, PeerClient, PeerTransferError, _PeerServer
from .topic import CDN_SERVICE, Announce, read_announce, read_head, verify_chunk_bytes

logger = logging.getLogger(__name__)

# Opaque checksum-table stand-in for pooled chunks: their integrity is
# carried by the self-describing chunk key, not a table entry.
_CDN_ENTRY = ("cdn",)

# Pull-latency samples kept per tier and subscriber (the newest).
_PULL_LATENCY_SAMPLES = 4096


class CdnSyncError(RuntimeError):
    """A chunk could not be obtained from any tier (peer and durable)."""


@dataclasses.dataclass
class SubscriberStats:
    """Per-subscriber bytes and chunks by tier, with staleness samples
    (publish to swap, seconds)."""

    updates_applied: int = 0
    chunks_held: int = 0
    chunks_from_peer: int = 0
    chunks_from_durable: int = 0
    bytes_from_peer: int = 0
    bytes_from_durable: int = 0
    peer_fallbacks: int = 0
    staleness_s: List[float] = dataclasses.field(default_factory=list)
    # tier ("peer" | "durable") -> pull wall-clock samples in seconds (a
    # peer sample includes the pacer's retries).
    pull_latency_s: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    @property
    def bytes_on_wire(self) -> int:
        return self.bytes_from_peer + self.bytes_from_durable

    def observe_pull(self, tier: str, seconds: float) -> None:
        samples = self.pull_latency_s.setdefault(tier, [])
        samples.append(seconds)
        if len(samples) > _PULL_LATENCY_SAMPLES:
            del samples[: len(samples) - _PULL_LATENCY_SAMPLES]


class CdnSubscriber:
    """One serving process tracking one topic.

    ``subscriber_id`` is unique in ``[0, fleet_size)``: the subscriber's
    rank in the owner table and its slot in the endpoint registry.
    ``durable_fetch(key) -> bytes`` reads a chunk from storage (owners
    always, others only after a pull times out). ``cas_store`` (optional)
    records the held chunk set as a lease, so that the training job's GC
    never deletes chunks the fleet still serves from. ``root`` (the
    training job's manager root) receives a ``cdn-swapped`` ledger event
    per applied step, where a run ledger exists."""

    def __init__(
        self,
        store: Store,
        topic: str,
        subscriber_id: int,
        fleet_size: int,
        durable_fetch: Optional[Callable[[str], bytes]] = None,
        cache_budget_bytes: Optional[int] = None,
        host: str = "127.0.0.1",
        root: Optional[str] = None,
        cas_store: Optional[object] = None,
    ) -> None:
        self._store = store
        self.topic = topic
        self.subscriber_id = int(subscriber_id)
        self.fleet_size = max(1, int(fleet_size))
        self._durable_fetch = durable_fetch
        self._cas_store = cas_store
        self._root = root
        self.stats = SubscriberStats()
        self.applied_seq = 0
        self.applied_step: Optional[int] = None
        self._held: Dict[str, int] = {}  # chunk key -> nbytes pooled
        self._pacer = _PollPacer(cap=scaled_poll_cap(self.fleet_size))
        self._clients: Dict[int, PeerClient] = {}
        self._cache = PeerCache(
            budget=PeerCacheBudget(cache_budget_bytes) if cache_budget_bytes is not None else None,
            keep_last_n=2,
        )
        self._server = _PeerServer((host, 0), self._cache)
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            daemon=True,
            name=f"cdn-sub-{subscriber_id}",
        )
        self._thread.start()
        self.host, self.port = self._server.server_address[:2]
        publish_endpoint(store, CDN_SERVICE, self.subscriber_id, self.host, self.port)
        self._fleet: Optional[wire.FleetReporter] = None
        if knobs.is_fleet_obs_enabled():
            self._fleet = wire.FleetReporter(store, "subscriber", str(self.subscriber_id), world=self.fleet_size)

    # -- topic tracking ---------------------------------------------------

    def poll_once(self) -> Optional[Announce]:
        """One head read: the newest unapplied announce, or None."""
        head = read_head(self._store, self.topic)
        if head <= self.applied_seq:
            return None
        return read_announce(self._store, self.topic, head)

    def wait_for_update(self, timeout: Optional[float] = None) -> Optional[Announce]:
        """Poll the head with pacer backoff until a new announce lands (or
        the deadline passes): one key read per backoff interval, no
        collective with the publisher."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        self._pacer.reset()
        while True:
            ann = self.poll_once()
            if ann is not None:
                return ann
            if deadline is not None and time.monotonic() >= deadline:
                return None
            self._pacer.sleep(deadline)

    # -- chunk sync -------------------------------------------------------

    def _step_key(self, ann: Announce) -> str:
        return f"cdn/{self.topic}/{ann.seq}"

    def _client_for(self, owner: int) -> Optional[PeerClient]:
        client = self._clients.get(owner)
        if client is not None:
            return client
        ep = lookup_endpoints(self._store, CDN_SERVICE, [owner]).get(owner)
        if ep is None:
            return None
        client = PeerClient(ep[0], ep[1], timeout=knobs.get_cdn_pull_timeout_seconds())
        self._clients[owner] = client
        return client

    def _fetch_durable(self, key: str) -> bytes:
        if self._durable_fetch is None:
            raise CdnSyncError(f"chunk {key}: no peer copy and no durable_fetch configured")
        t0 = time.monotonic()
        data = self._durable_fetch(key)
        if not verify_chunk_bytes(key, data):
            raise CdnSyncError(f"chunk {key}: durable copy fails its digest")
        self.stats.observe_pull("durable", time.monotonic() - t0)
        self.stats.chunks_from_durable += 1
        self.stats.bytes_from_durable += len(data)
        telemetry.metrics().counter_inc(metric_names.CDN_PULL_BYTES_TOTAL, float(len(data)), tier="durable")
        return data

    def _fetch_from_peer(self, key: str, owner: int, step_key: str) -> Optional[bytes]:
        """Pull one chunk from its owner, pacer-retried until the pull
        timeout; None when every attempt missed or failed (the caller reads
        durable storage)."""
        t0 = time.monotonic()
        deadline = t0 + knobs.get_cdn_pull_timeout_seconds()
        path = chunk_location(key)
        pacer = _PollPacer(cap=scaled_poll_cap(self.fleet_size))
        while True:
            client = self._client_for(owner)
            if client is not None:
                try:
                    found = client.pull(step_key, path)
                except PeerTransferError:
                    found = None
                if found is not None:
                    data = found[1]
                    if verify_chunk_bytes(key, data):
                        self.stats.observe_pull("peer", time.monotonic() - t0)
                        self.stats.chunks_from_peer += 1
                        self.stats.bytes_from_peer += len(data)
                        telemetry.metrics().counter_inc(
                            metric_names.CDN_PULL_BYTES_TOTAL, float(len(data)), tier="peer"
                        )
                        return data
                    # A damaged frame: drop the connection and retry; bytes
                    # the key disowns are never pooled.
                    client.close()
                    self._clients.pop(owner, None)
            if time.monotonic() >= deadline:
                return None
            pacer.sleep(deadline)

    def sync(self, ann: Announce) -> Dict[str, bytes]:
        """Materialize the announce's full chunk set here, fetching only
        what this subscriber does not hold. Returns ``key -> bytes`` for
        every chunk of the step."""
        step_key = self._step_key(ann)
        out: Dict[str, bytes] = {}
        wanted = sorted(set(ann.chunks) - set(self._held))
        owners = assign_shard_owners((chunk_location(k) for k in wanted), self.fleet_size)
        with wire.propagate(metric_names.RPC_CDN_SYNC), _trace_recorder().span(
            metric_names.SPAN_CDN_SYNC, topic=self.topic, seq=ann.seq, novel=len(wanted)
        ):
            for key in sorted(ann.chunks):
                path = chunk_location(key)
                if key not in wanted:
                    held = self._cache.get(step_key, path)
                    if held is not None:
                        self.stats.chunks_held += 1
                        telemetry.metrics().counter_inc(metric_names.CDN_CHUNKS_HELD_TOTAL)
                        self._cache.put(step_key, ann.step, path, _CDN_ENTRY, held[1])
                        out[key] = held[1]
                        continue
                    # The held-set record outlived the pooled copy (budget
                    # eviction): the chunk is novel again.
                    self._held.pop(key, None)
                owner = owners.get(path, self.subscriber_id)
                if owner == self.subscriber_id:
                    data = self._fetch_durable(key)
                else:
                    data = self._fetch_from_peer(key, owner, step_key)
                    if data is None:
                        self.stats.peer_fallbacks += 1
                        data = self._fetch_durable(key)
                self._cache.put(step_key, ann.step, path, _CDN_ENTRY, data)
                self._held[key] = len(data)
                out[key] = data
        self._cache.commit(step_key, ann.step)
        return out

    # -- apply (sync + hot swap) ------------------------------------------

    def apply(self, ann: Announce, swapper: Optional[object] = None) -> bool:
        """Sync the announce and hot-swap it in. The crash point sits
        between staging and the swap: a subscriber killed there has staged
        buffers, but serves the previous fully applied step (no torn swap).
        Returns True on success."""
        chunk_bytes = self.sync(ann)
        swap_started = time.monotonic()
        if swapper is not None:
            staged = swapper.stage(ann, chunk_bytes)
            crashpoint(metric_names.CRASH_CDN_SWAP_STAGED)
            swapper.swap(staged)
        else:
            crashpoint(metric_names.CRASH_CDN_SWAP_STAGED)
        swap_s = time.monotonic() - swap_started
        self.applied_seq = ann.seq
        self.applied_step = ann.step
        staleness = max(0.0, time.time() - ann.published_ts)
        self.stats.updates_applied += 1
        self.stats.staleness_s.append(staleness)
        registry = telemetry.metrics()
        registry.counter_inc(metric_names.CDN_UPDATES_APPLIED_TOTAL)
        registry.histogram_observe(metric_names.CDN_STALENESS_SECONDS, staleness)
        if self._fleet is not None:
            try:
                self._fleet.publish(
                    phase=f"serving:{ann.step}",
                    written_bytes=self.stats.bytes_on_wire,
                    extra={"seq": ann.seq, "staleness_s": round(staleness, 3)},
                )
            except Exception:  # noqa: BLE001 - observability never blocks
                pass
        registry.histogram_observe(metric_names.CDN_SWAP_SECONDS, swap_s)
        self._lease_held()
        if self._root is not None:
            ledger.post_event(
                self._root,
                metric_names.EVENT_CDN_SWAPPED,
                topic=self.topic,
                seq=ann.seq,
                step=ann.step,
                subscriber=self.subscriber_id,
                staleness_s=round(staleness, 6),
                swap_s=round(swap_s, 6),
                bytes_on_wire=self.stats.bytes_on_wire,
            )
        return True

    def track_once(self, swapper: Optional[object] = None, timeout: Optional[float] = None) -> Optional[Announce]:
        """One wait-sync-swap cycle. None when no update arrived within the
        timeout."""
        ann = self.wait_for_update(timeout)
        if ann is None:
            return None
        self.apply(ann, swapper)
        return ann

    # -- chunk-store lease (the GC pin) -----------------------------------

    @property
    def lease_id(self) -> str:
        return f"cdn/{self.topic}/{self.subscriber_id}"

    def _lease_held(self) -> None:
        """Re-lease the held chunk set (replacing this subscriber's
        previous lease): the training job's GC counts leased chunks as live,
        so fleet-held chunks survive step retention. Best-effort: a lease
        failure risks a later durable re-fetch, never a torn swap."""
        if self._cas_store is None:
            return
        try:
            self._cas_store.lease(self.lease_id, dict(self._held))
        except Exception as e:  # noqa: BLE001
            logger.warning("cdn: lease update for %r failed: %r", self.lease_id, e)

    def close(self, release_lease: bool = True) -> None:
        if self._fleet is not None:
            self._fleet.close()
            self._fleet = None
        if release_lease and self._cas_store is not None:
            try:
                self._cas_store.unlease(self.lease_id)
            except Exception as e:  # noqa: BLE001
                logger.warning("cdn: unlease of %r failed: %r", self.lease_id, e)
        for client in self._clients.values():
            client.close()
        self._clients.clear()
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:  # noqa: BLE001
            pass
        self._thread.join(timeout=5.0)


def durable_chunk_reader(root_url: str) -> Callable[[str], bytes]:
    """A ``durable_fetch`` that reads ``chunks/<key>`` under a snapshot
    root through its storage plugin (one plugin and event loop per reader,
    reused across fetches)."""
    import asyncio

    from ..cas import CHUNKS_DIRNAME
    from ..io_types import ReadIO
    from ..storage_plugin import url_to_storage_plugin

    lock = threading.Lock()
    state: Dict[str, object] = {}

    def fetch(key: str) -> bytes:
        with lock:
            if "plugin" not in state:
                state["plugin"] = url_to_storage_plugin(root_url)
                state["loop"] = asyncio.new_event_loop()
            plugin = state["plugin"]
            loop = state["loop"]
            read_io = ReadIO(path=f"{CHUNKS_DIRNAME}/{key}")
            loop.run_until_complete(plugin.read(read_io))  # type: ignore[union-attr]
            return bytes(read_io.buf)

    return fetch
