"""Peer-RAM checkpoint tier: recovery from a preemption at host-RAM speed.

Counterpart of ``torchsnapshot_tpu/tiered/peer.py``, with the same wire
protocol, placement journal and restore ladder. After each commit every
rank pushes the blobs it wrote into a neighbour rank's host-RAM cache
(ring placement, ``(rank + offset) % world``), so that after a single-rank
preemption the replacement rank pulls its blobs from the surviving peer's
memory instead of from storage.

Topology and transport:

- Each configured process runs one cache server (daemon threads) over a
  :class:`PeerCache` bounded by a
  :class:`~torchsnapshot_tpu_torch.scheduler.PeerCacheBudget`: LRU by
  step, the newest committed step pinned.
- Requests are pickled ``(cmd, args)`` tuples of builtin types in the
  store's length-prefixed frames (``dist_store.send_frame``, so the chaos
  wire hook covers them), so a server of either package answers a client
  of the other. The JAX client prefixes its frames with a trace header;
  this server strips it (:func:`_strip_trace_header`). The port's frames
  carry none.
- Endpoints ride the store's endpoint registry
  (``dist_store.publish_endpoint``, overwritten on re-publish: a
  replacement rank re-announces itself under its old rank id).
- Pushes run on one background worker with a per-transfer timeout under
  the collective-progress retry strategy: a dead peer costs a bounded
  number of timeouts, then the tier *degrades* (a warning, the
  ``peer_tier_degraded`` gauge), never a wedged save. Each push job
  writes a placement doc (``.peer_placement-rank<r>.json``) into the step
  (its fast tier on a tiered root), which ``fsck --tier peer`` audits.

Restore ladder, per blob: **peer RAM -> local fast tier -> durable**,
except that a blob still on the local fast tier is read there (a local
copy is free; only the bytes this host lost cross the wire).
:func:`build_restore_context` asks every advertised peer for its inventory
of the step (one RPC each, concurrently; a dead peer is skipped), and
:meth:`PeerRestoreContext.wrap` gives the read pipeline a plugin view that
pulls table-resident blobs from peer RAM, digest-verified before they are
trusted, ranged reads of paged blobs sliced on the server. Any failure
(dead peer, stale step, checksum mismatch, a refused push) falls through
to storage for that blob: a restore is correct, at worst slower.

Kill switch: ``TORCHSNAPSHOT_TPU_PEER_TIER=0`` (no server, no pushes, no
pulls). Knobs: ring offset, cache budget, transfer timeout (``knobs.py``).

Left out against the JAX package (ROADMAP queue 3): the wire observatory
(dial, RPC, pool-checkout and accept-depth accounting, frame counts) and
the trace-context propagation of its frames, with the ``wire:rpc`` /
``wire:handler`` spans, come with the wire observatory (step 10c). A peer
pull stamps ``ReadIO.verified_entry``, so the read pipeline does not
verify those bytes a second time (the JAX pipeline does).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import pickle
import queue
import socket
import socketserver
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import knobs, telemetry
from ..dist_store import (
    Store,
    _strip_trace_header,
    lookup_endpoint,
    lookup_endpoints,
    publish_endpoint,
    recv_frame,
    send_frame,
)
from ..event_loop import run_in_fresh_event_loop
from ..integrity import ChecksumError, verify_checksum
from ..io_types import ReadIO, StoragePlugin, WriteIO
from ..scheduler import PeerCacheBudget
from ..storage_plugin import split_tiered_url, url_to_storage_plugin
from ..storage_plugins.retry import CollectiveProgressRetryStrategy, RetriesExhausted
from ..telemetry import names as metric_names
from ..telemetry.ledger import step_from_path
from ..telemetry.trace import get_recorder as _trace_recorder

logger: logging.Logger = logging.getLogger(__name__)

# Endpoint-registry service name (dist_store.publish_endpoint).
PEER_SERVICE = "peer-tier"

# Placement-doc basename prefix: one doc per pushing rank per step.
PEER_PLACEMENT_PREFIX = ".peer_placement-rank"

# A pulling endpoint is dead for the rest of one restore after this many
# consecutive transport failures (a checksum mismatch does not count: the
# transport is fine, the bytes are not).
_PULL_DEAD_AFTER_FAILURES = 2

def peer_step_key(path_url: str) -> str:
    """The cache key of one snapshot path: the fast-tier URL of a tiered
    path (the same string on every rank), the path itself otherwise."""
    tiers = split_tiered_url(path_url)
    base = tiers[0] if tiers is not None else path_url
    return base.rstrip("/")


def placement_doc_path(rank: int) -> str:
    return f"{PEER_PLACEMENT_PREFIX}{rank}.json"


def _is_chunk(path: str) -> bool:
    from ..cas import is_chunk_location

    return is_chunk_location(path)


class PeerTransferError(RuntimeError):
    """A peer transport operation failed (connect, timeout, protocol)."""


# ---------------------------------------------------------------------------
# The cache (the receiving side's host RAM)
# ---------------------------------------------------------------------------


class _StepSlot:
    __slots__ = ("blobs", "committed", "step", "chunk_refs")

    def __init__(self, step: Optional[int]) -> None:
        # path -> (checksum-table entry, bytes)
        self.blobs: Dict[str, Tuple[tuple, bytes]] = {}
        # Content-addressed blobs this step references in the shared pool.
        self.chunk_refs: set = set()
        self.committed = False
        self.step = step

    @property
    def holds_bytes(self) -> bool:
        return bool(self.blobs or self.chunk_refs)


class PeerCache:
    """Host-RAM store of peer-pushed blobs. Steps evict LRU (arrival and
    commit order) under the byte budget, the newest committed step pinned:
    it is the one a replacement rank asks for. A push that cannot fit
    after evicting every unpinned step is refused (``(False,
    "budget")``); the pusher records it and restores fall through."""

    def __init__(self, budget: Optional[PeerCacheBudget] = None, keep_last_n: Optional[int] = None) -> None:
        self._budget = budget if budget is not None else PeerCacheBudget(knobs.get_peer_cache_budget_bytes())
        self.keep_last_n = keep_last_n
        self._lock = threading.Lock()
        # Insertion order is LRU order (a commit re-inserts).
        self._steps: Dict[str, _StepSlot] = {}
        self._pinned: Optional[str] = None
        # The chunk pool: a content-addressed blob is stored once across
        # steps, refcounted by the step slots that reference it; its
        # budget bytes go when the last reference does.
        self._chunks: Dict[str, Tuple[tuple, bytes]] = {}
        self._chunk_rc: Dict[str, int] = {}

    # -- mutation (server handler threads) ------------------------------

    def _slot_locked(self, step_key: str, step: Optional[int]) -> _StepSlot:
        slot = self._steps.get(step_key)
        if slot is None:
            slot = self._steps[step_key] = _StepSlot(step)
        return slot

    def _ref_chunk_locked(self, slot: _StepSlot, path: str) -> None:
        if path not in slot.chunk_refs:
            slot.chunk_refs.add(path)
            self._chunk_rc[path] = self._chunk_rc.get(path, 0) + 1

    def reference_chunks(self, step_key: str, step: Optional[int], paths: List[str]) -> List[str]:
        """Dedup by digest: reference under ``step_key`` the chunk paths
        already pooled and return them; the pusher ships the rest."""
        with self._lock:
            hits = [p for p in paths if p in self._chunks]
            if hits:
                slot = self._slot_locked(step_key, step)
                for p in hits:
                    self._ref_chunk_locked(slot, p)
            self._publish_gauges_locked()
            return hits

    def _reserve_locked(self, nbytes: int, step_key: str) -> bool:
        while not self._budget.try_reserve(nbytes):
            if not self._evict_one_locked(exclude=step_key):
                return False
        return True

    def put(self, step_key: str, step: Optional[int], path: str, entry: tuple, data: bytes) -> Tuple[bool, str]:
        nbytes = len(data)
        with self._lock:
            try:
                if nbytes > self._budget.total_bytes:
                    # Doomed: refused without evicting anything, as no
                    # eviction could make it fit.
                    return False, "budget"
                slot = self._slot_locked(step_key, step)
                if _is_chunk(path):
                    # The path names the content: a pooled copy serves
                    # every step.
                    if path not in self._chunks:
                        if not self._reserve_locked(nbytes, step_key):
                            return False, "budget"
                        self._chunks[path] = (tuple(entry), data)
                    self._ref_chunk_locked(slot, path)
                    return True, "ok"
                prior = slot.blobs.pop(path, None)
                if prior is not None:
                    self._budget.release(len(prior[1]))
                if not self._reserve_locked(nbytes, step_key):
                    return False, "budget"
                slot.blobs[path] = (tuple(entry), data)
                return True, "ok"
            finally:
                self._publish_gauges_locked()

    def commit(self, step_key: str, step: Optional[int]) -> None:
        with self._lock:
            slot = self._steps.pop(step_key, None) or _StepSlot(step)
            slot.committed = True
            if step is not None:
                slot.step = step
            self._steps[step_key] = slot  # the newest LRU position
            # An empty committed step (every push refused) neither steals
            # the pin nor competes for the retention window: the older
            # copy is still the newest a replacement rank could use.
            if slot.holds_bytes:
                self._pinned = step_key
            if self.keep_last_n is not None:
                committed = [k for k, s in self._steps.items() if s.committed and s.holds_bytes]
                for old in committed[: -max(1, self.keep_last_n)]:
                    self._drop_locked(old)
            self._publish_gauges_locked()

    def evict_step(self, step_key: str) -> bool:
        with self._lock:
            if step_key not in self._steps:
                return False
            self._drop_locked(step_key)
            self._publish_gauges_locked()
            return True

    def _drop_locked(self, step_key: str) -> None:
        slot = self._steps.pop(step_key, None)
        if slot is None:
            return
        for _, data in slot.blobs.values():
            self._budget.release(len(data))
        for path in slot.chunk_refs:
            rc = self._chunk_rc.get(path, 0) - 1
            if rc > 0:
                self._chunk_rc[path] = rc
                continue
            self._chunk_rc.pop(path, None)
            pooled = self._chunks.pop(path, None)
            if pooled is not None:
                self._budget.release(len(pooled[1]))
        if self._pinned == step_key:
            self._pinned = None

    def _evict_one_locked(self, exclude: str) -> bool:
        for key in self._steps:
            if key not in (exclude, self._pinned):
                self._drop_locked(key)
                return True
        return False

    # -- reads ----------------------------------------------------------

    def get(self, step_key: str, path: str) -> Optional[Tuple[tuple, bytes]]:
        with self._lock:
            if _is_chunk(path) and path in self._chunks:
                return self._chunks[path]  # a pooled chunk serves any step
            slot = self._steps.get(step_key)
            return None if slot is None else slot.blobs.get(path)

    def inventory(self, step_key: str) -> Dict[str, tuple]:
        with self._lock:
            slot = self._steps.get(step_key)
            if slot is None:
                return {}
            out = {p: e for p, (e, _) in slot.blobs.items()}
            for p in slot.chunk_refs:
                if p in self._chunks:
                    out[p] = self._chunks[p][0]
            return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "steps": len(self._steps),
                "blobs": sum(len(s.blobs) for s in self._steps.values()),
                "chunks": len(self._chunks),
                "chunk_bytes": sum(len(d) for _, d in self._chunks.values()),
                "bytes": self._budget.reserved_bytes(),
                "budget_bytes": self._budget.total_bytes,
                "pinned": self._pinned,
                "committed_steps": sorted(k for k, s in self._steps.items() if s.committed),
            }

    def _publish_gauges_locked(self) -> None:
        registry = telemetry.metrics()
        registry.gauge_set(metric_names.PEER_CACHE_BYTES, self._budget.reserved_bytes())
        registry.gauge_set(metric_names.PEER_CACHE_STEPS, len(self._steps))


# ---------------------------------------------------------------------------
# Transport: server and client (length-prefixed frames, pickled tuples)
# ---------------------------------------------------------------------------


class _PeerServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    # The stock backlog of 5 drops connects when a fleet dials at once.
    request_queue_size = 128

    def __init__(self, addr, cache: PeerCache) -> None:
        super().__init__(addr, _PeerRequestHandler)
        self.cache = cache


class _PeerRequestHandler(socketserver.BaseRequestHandler):
    def _dispatch(self, cmd: str, args: tuple, cache: PeerCache) -> Any:
        if cmd == metric_names.RPC_PEER_PUSH:
            step_key, step, path, entry, data = args
            return cache.put(step_key, step, path, entry, data)
        if cmd == metric_names.RPC_PEER_COMMIT:
            step_key, step = args
            cache.commit(step_key, step)
            return (True, "ok")
        if cmd == metric_names.RPC_PEER_PULL:
            step_key, path, rng = args if len(args) == 3 else (*args, None)
            found = cache.get(step_key, path)
            registry = telemetry.metrics()
            if found is None:
                registry.counter_inc(metric_names.PEER_PULL_MISSES_TOTAL)
                return None
            if rng is not None:
                # Sliced here: a ranged read ships only its window.
                found = (found[0], found[1][int(rng[0]) : int(rng[1])])
            registry.counter_inc(metric_names.PEER_PULL_HITS_TOTAL)
            registry.counter_inc(metric_names.PEER_PULL_BYTES_TOTAL, len(found[1]))
            return found
        if cmd == metric_names.RPC_PEER_REFCHUNKS:
            step_key, step, paths = args
            return cache.reference_chunks(step_key, step, list(paths))
        if cmd == metric_names.RPC_PEER_LIST:
            return cache.inventory(args[0])
        if cmd == metric_names.RPC_PEER_EVICT:
            return cache.evict_step(args[0])
        if cmd == metric_names.RPC_PEER_STATS:
            return cache.stats()
        if cmd == metric_names.RPC_PEER_PING:
            return "pong"
        return None

    def handle(self) -> None:
        cache = self.server.cache  # type: ignore[attr-defined]
        try:
            while True:
                cmd, args = pickle.loads(_strip_trace_header(recv_frame(self.request)))
                send_frame(self.request, pickle.dumps(self._dispatch(cmd, args, cache)))
        except (ConnectionError, EOFError, OSError):
            return


class PeerClient:
    """One connection to a peer's cache server. Every operation is bounded
    by the transfer timeout (the connect and each socket operation), and
    any failure raises :class:`PeerTransferError` with the connection torn
    down: the next call redials."""

    def __init__(self, host: str, port: int, timeout: Optional[float] = None) -> None:
        self.host = host
        self.port = port
        self.timeout = timeout if timeout is not None else knobs.get_peer_transfer_timeout_seconds()
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            sock = socket.create_connection((self.host, self.port), timeout=self.timeout)
            sock.settimeout(self.timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
        return self._sock

    def request(self, cmd: str, *args: Any) -> Any:
        with self._lock:
            try:
                sock = self._connect()
                send_frame(sock, pickle.dumps((cmd, args)))
                return pickle.loads(_strip_trace_header(recv_frame(sock)))
            except (OSError, EOFError, pickle.PickleError) as e:
                self._teardown_locked()
                raise PeerTransferError(f"peer {self.host}:{self.port} {cmd} failed: {e!r}") from e

    def _teardown_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._teardown_locked()

    def push(self, step_key: str, step: Optional[int], path: str, entry: tuple, data: bytes) -> Tuple[bool, str]:
        return tuple(self.request(metric_names.RPC_PEER_PUSH, step_key, step, path, entry, data))

    def commit(self, step_key: str, step: Optional[int]) -> None:
        self.request(metric_names.RPC_PEER_COMMIT, step_key, step)

    def reference_chunks(self, step_key: str, step: Optional[int], paths: List[str]) -> List[str]:
        """Which of these chunk paths the peer already pools (now
        referenced under ``step_key``); the pusher ships only the rest."""
        return list(self.request(metric_names.RPC_PEER_REFCHUNKS, step_key, step, list(paths)))

    def pull(
        self, step_key: str, path: str, byte_range: Optional[Tuple[int, int]] = None
    ) -> Optional[Tuple[tuple, bytes]]:
        return self.request(metric_names.RPC_PEER_PULL, step_key, path, byte_range)

    def list_step(self, step_key: str) -> Dict[str, tuple]:
        return dict(self.request(metric_names.RPC_PEER_LIST, step_key))

    def evict(self, step_key: str) -> bool:
        return bool(self.request(metric_names.RPC_PEER_EVICT, step_key))

    def stats(self) -> Dict[str, Any]:
        return dict(self.request(metric_names.RPC_PEER_STATS))

    def ping(self) -> bool:
        """A full round trip through the peer's dispatch loop (a hung
        server reads as dead). True iff the peer answered."""
        try:
            return self.request(metric_names.RPC_PEER_PING) == "pong"
        except (OSError, RuntimeError):
            return False


# ---------------------------------------------------------------------------
# The replicator (the pushing side's background worker)
# ---------------------------------------------------------------------------


class PeerPushJob:
    """One step's push work: its blob inventory and completion handle."""

    def __init__(
        self, path_url: str, step_key: str, step: Optional[int], blobs: Dict[str, Optional[tuple]], committed: bool
    ) -> None:
        self.path_url = path_url
        self.step_key = step_key
        self.step = step
        self.blobs = dict(blobs)
        self.committed = committed
        self.done_evt = threading.Event()
        self.error: Optional[BaseException] = None
        self.blobs_pushed = 0
        self.bytes_pushed = 0
        self.pushed: List[str] = []
        self.blobs_refused = 0
        self.blobs_skipped = 0
        self.blobs_failed = 0
        # Chunks the peer already pooled: placed without crossing the wire.
        self.blobs_deduped = 0
        self.bytes_deduped = 0
        self.target_rank: Optional[int] = None
        self.endpoint: Optional[Tuple[str, int]] = None
        # Seconds from the worker picking the job up to it settling.
        self.seconds: Optional[float] = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done_evt.wait(timeout)


class PeerReplicator:
    """The process's peer tier: its cache server and the background push
    worker. Inert until :meth:`configure` (a store and rank coordinates);
    before that every public method falls back to a no-op shape."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._configured = False
        self._store: Optional[Store] = None
        self._rank = 0
        self._world = 1
        self._server: Optional[_PeerServer] = None
        self._server_thread: Optional[threading.Thread] = None
        self.cache = PeerCache()
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self._queue: "queue.Queue[Optional[PeerPushJob]]" = queue.Queue()
        self._jobs: List[PeerPushJob] = []
        self._worker: Optional[threading.Thread] = None
        self._stopped = False
        self.degraded = False
        self._failures = 0

    # -- setup -----------------------------------------------------------

    def configure(self, store: Store, rank: int, world_size: int, keep_last_n: Optional[int] = None) -> bool:
        """Start the cache server (once) and advertise its endpoint.
        Idempotent: a re-configure refreshes ``keep_last_n`` and
        re-publishes the endpoint (a replacement rank's re-announce)."""
        with self._lock:
            if self._stopped:
                return False
            self._store = store
            self._rank = int(rank)
            self._world = int(world_size)
            if keep_last_n is not None:
                self.cache.keep_last_n = keep_last_n
            if self._server is None:
                server = _PeerServer(("0.0.0.0", 0), self.cache)
                self._server = server
                self.port = server.server_address[1]
                self.host = _advertise_host()
                self._server_thread = threading.Thread(
                    target=server.serve_forever, name="peer-tier-server", daemon=True
                )
                self._server_thread.start()
            self._configured = True
        try:
            publish_endpoint(store, PEER_SERVICE, self._rank, self.host, self.port)
        except Exception as e:  # noqa: BLE001 - degraded, not fatal
            logger.warning("peer tier: endpoint publish failed: %r", e)
            self._note_degraded()
        return True

    @property
    def configured(self) -> bool:
        return self._configured

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world

    def endpoint_for(self, rank: int) -> Optional[Tuple[str, int]]:
        return None if self._store is None else lookup_endpoint(self._store, PEER_SERVICE, rank)

    def resolve_endpoints(self, ranks) -> Dict[int, Tuple[str, int]]:
        """Every advertised endpoint of ``ranks`` in one store round trip;
        {} before configure or on a failed registry read."""
        return {} if self._store is None else lookup_endpoints(self._store, PEER_SERVICE, ranks)

    def target_rank(self) -> int:
        return (self._rank + knobs.get_peer_ring_offset()) % max(1, self._world)

    def stop_server(self) -> None:
        """Shut this process's cache server down and keep the rest (a dead
        neighbour, as its pushers see it: its endpoint stays published)."""
        with self._lock:
            server, self._server = self._server, None
            thread, self._server_thread = self._server_thread, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=10)

    # -- pushing ---------------------------------------------------------

    def enqueue_push(
        self, path_url: str, blobs: Dict[str, Optional[tuple]], committed: bool = True, step: Optional[int] = None
    ) -> Optional[PeerPushJob]:
        """Queue one step's blobs for the ring neighbour; returns the
        job, or None when the tier cannot run (not configured, a world of
        one, or a ring offset that maps the rank onto itself)."""
        with self._lock:
            if not self._configured or self._stopped or self._world <= 1 or not blobs:
                return None
            if self.target_rank() == self._rank:
                return None
            job = PeerPushJob(path_url, peer_step_key(path_url), step, blobs, committed)
            # Keep every unsettled job (drain() waits on all of them) and
            # the newest few failures (state()).
            unsettled = [j for j in self._jobs if not j.done_evt.is_set()]
            failed = [j for j in self._jobs if j.done_evt.is_set() and j.error is not None][-8:]
            self._jobs = failed + unsettled + [job]
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._worker_main, name="peer-tier-push", daemon=True)
                self._worker.start()
        self._queue.put(job)
        return job

    def last_job(self) -> Optional[PeerPushJob]:
        with self._lock:
            return self._jobs[-1] if self._jobs else None

    def _worker_main(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            recorder = _trace_recorder()
            span = recorder.begin(metric_names.SPAN_PEER_JOB, step=job.step_key, blobs=len(job.blobs))
            t0 = time.monotonic()
            try:
                run_in_fresh_event_loop(self._run_job(job))
                if job.blobs_failed == 0 and job.blobs_refused == 0:
                    self._clear_degraded()
            except BaseException as e:  # noqa: BLE001 - degrade, never raise
                job.error = e
                self._note_degraded()
                logger.warning(
                    "peer tier: push of %s to rank %s degraded (%r); the restore ladder "
                    "falls through to storage",
                    job.step_key, job.target_rank, e,
                )
            finally:
                job.seconds = time.monotonic() - t0
                recorder.end(span)
                self._settle_telemetry(job)
                job.done_evt.set()
                self._queue.task_done()

    async def _run_job(self, job: PeerPushJob) -> None:
        job.target_rank = self.target_rank()
        job.endpoint = endpoint = self.endpoint_for(job.target_rank)
        if endpoint is None:
            raise PeerTransferError(f"rank {job.target_rank} published no peer endpoint")
        timeout = knobs.get_peer_transfer_timeout_seconds()
        storage = url_to_storage_plugin(job.path_url)
        client = PeerClient(endpoint[0], endpoint[1], timeout=timeout)
        retry = CollectiveProgressRetryStrategy(progress_window_seconds=timeout, scope="peer")
        loop = asyncio.get_running_loop()

        async def rpc(fn, *args):
            async def once():
                return await loop.run_in_executor(None, fn, *args)

            return await retry.run(once, retriable_exceptions=(PeerTransferError,))

        try:
            # Dedup by digest in one RPC: chunks the neighbour already
            # pools are referenced under this step; no bytes move.
            deduped = set()
            chunk_paths = sorted(p for p in job.blobs if _is_chunk(p))
            if chunk_paths:
                for p in await rpc(client.reference_chunks, job.step_key, job.step, chunk_paths):
                    deduped.add(p)
                    job.blobs_deduped += 1
                    entry = job.blobs.get(p)
                    if entry is not None and len(entry) >= 3:
                        job.bytes_deduped += int(entry[2])
                    job.pushed.append(p)
            for path in sorted(job.blobs):
                if path in deduped:
                    continue
                read_io = ReadIO(path=path)
                try:
                    await storage.read(read_io)
                except FileNotFoundError:
                    job.blobs_skipped += 1  # GC raced the push: nothing to replicate
                    continue
                data = bytes(read_io.buf)
                entry = job.blobs[path]
                if entry is None:
                    from ..integrity import compute_checksum_entry

                    entry = compute_checksum_entry(data)
                with _trace_recorder().span(metric_names.SPAN_PEER_PUSH, blob=path):
                    accepted, _ = await rpc(client.push, job.step_key, job.step, path, entry, data)
                if accepted:
                    job.blobs_pushed += 1
                    job.bytes_pushed += len(data)
                    job.pushed.append(path)
                else:
                    # The peer's budget refused it: permanent for this
                    # step. Counted; the ladder falls through.
                    job.blobs_refused += 1
            if job.committed:
                await rpc(client.commit, job.step_key, job.step)
            await self._write_placement(storage, job)
        except (PeerTransferError, RetriesExhausted) as e:
            # Only blobs neither pushed, refused, skipped nor deduped
            # failed on the transport.
            job.blobs_failed = max(
                0,
                len(job.blobs) - job.blobs_pushed - job.blobs_refused - job.blobs_skipped - job.blobs_deduped,
            )
            try:
                await self._write_placement(storage, job, error=repr(e))
            except Exception:  # noqa: BLE001 - already degrading
                pass
            raise
        finally:
            client.close()
            await storage.close()

    async def _write_placement(self, storage: StoragePlugin, job: PeerPushJob, error: Optional[str] = None) -> None:
        """The push's placement doc (the fast tier of a tiered root): the
        offline record of which blobs have a peer copy where, which
        ``fsck --tier peer`` audits. The JAX package's schema."""
        from .plugin import TieredStoragePlugin

        doc = {
            "step_key": job.step_key,
            "step": job.step,
            "pusher_rank": self._rank,
            "target_rank": job.target_rank,
            "endpoint": f"{job.endpoint[0]}:{job.endpoint[1]}" if job.endpoint else None,
            "committed": job.committed,
            "blobs_pushed": job.blobs_pushed,
            "blobs_refused": job.blobs_refused,
            "blobs_skipped": job.blobs_skipped,
            "blobs_failed": job.blobs_failed,
            "blobs_deduped": job.blobs_deduped,
            "bytes_pushed": job.bytes_pushed,
            "bytes_deduped": job.bytes_deduped,
            # Only the blobs that landed in the peer's RAM: the claim fsck
            # audits.
            "blobs": sorted(job.pushed),
            "blobs_total": len(job.blobs),
            "error": error,
            "unix_ts": round(time.time(), 3),
        }
        target = storage.fast if isinstance(storage, TieredStoragePlugin) else storage
        payload = json.dumps(doc, sort_keys=True).encode()
        await target.write(WriteIO(path=placement_doc_path(self._rank), buf=payload))

    def _settle_telemetry(self, job: PeerPushJob) -> None:
        registry = telemetry.metrics()
        registry.counter_inc(metric_names.PEER_PUSH_BLOBS_TOTAL, job.blobs_pushed)
        registry.counter_inc(metric_names.PEER_PUSH_BYTES_TOTAL, job.bytes_pushed)
        if job.blobs_deduped:
            registry.counter_inc(metric_names.PEER_PUSH_CHUNKS_DEDUPED_TOTAL, job.blobs_deduped)
            registry.counter_inc(metric_names.PEER_PUSH_BYTES_DEDUPED_TOTAL, job.bytes_deduped)
        failures = job.blobs_failed + job.blobs_refused
        if failures or job.error is not None:
            registry.counter_inc(metric_names.PEER_PUSH_FAILURES_TOTAL, max(1, failures))

    def _note_degraded(self) -> None:
        self.degraded = True
        self._failures += 1
        telemetry.metrics().gauge_set(metric_names.PEER_TIER_DEGRADED_STATE, 1)

    def _clear_degraded(self) -> None:
        if self.degraded:
            self.degraded = False
            telemetry.metrics().gauge_set(metric_names.PEER_TIER_DEGRADED_STATE, 0)

    # -- completion / lifecycle -----------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued push settles (True) or the timeout
        lapses (False): the preemption grace window's flush of the last
        committed step into the surviving peer's RAM."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._lock:
            jobs = list(self._jobs)
        for job in jobs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            if not job.wait(remaining):
                return False
        return True

    def state(self) -> Dict[str, Any]:
        with self._lock:
            pending = [j for j in self._jobs if not j.done_evt.is_set()]
            return {
                "configured": self._configured,
                "rank": self._rank,
                "world_size": self._world,
                "endpoint": f"{self.host}:{self.port}" if self.port else None,
                "degraded": self.degraded,
                "failures": self._failures,
                "jobs_pending": len(pending),
                "cache": self.cache.stats(),
            }

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._configured = False
            worker = self._worker
        self._queue.put(None)
        if worker is not None:
            worker.join(timeout=10)
        self.stop_server()


def _advertise_host() -> str:
    """The address peers dial for this process's cache server: this
    machine's own, never the store host's."""
    from ..dist_store import _local_advertise_host

    try:
        return _local_advertise_host()
    except Exception:  # noqa: BLE001 - last resort
        return socket.gethostname()


# ---------------------------------------------------------------------------
# The process's replicator and the integration hooks
# ---------------------------------------------------------------------------

_replicator: Optional[PeerReplicator] = None
_replicator_lock = threading.Lock()
# One-shot warning latch: the tier is on but inert (checksums off).
_WARNED_NO_CHECKSUMS = False


def get_replicator() -> PeerReplicator:
    global _replicator
    with _replicator_lock:
        if _replicator is None:
            _replicator = PeerReplicator()
        return _replicator


def _live_replicator() -> Optional[PeerReplicator]:
    with _replicator_lock:
        rep = _replicator
    return rep if rep is not None and rep.configured else None


def reset_peer_tier() -> None:
    """Stop and discard the process's replicator (a restarted, or
    preempted, process)."""
    global _replicator
    with _replicator_lock:
        rep, _replicator = _replicator, None
    if rep is not None:
        rep.stop()


def maybe_configure(pg: Any, keep_last_n: Optional[int] = None) -> bool:
    """Configure the tier for this process when the knob is on and a
    multi-rank store exists; False otherwise. Safe to repeat (manager
    construction, a replacement rank's restart)."""
    if not knobs.is_peer_tier_enabled():
        return False
    from ..pg_wrapper import PGWrapper

    wrapper = pg if isinstance(pg, PGWrapper) else PGWrapper(pg)
    if wrapper.store is None or wrapper.get_world_size() <= 1:
        return False
    return get_replicator().configure(
        wrapper.store, wrapper.get_rank(), wrapper.get_world_size(), keep_last_n=keep_last_n
    )


def maybe_enqueue_push(path: str, written: Dict[str, tuple], committed: bool = True) -> Optional[PeerPushJob]:
    """The commit hook (every rank): queue the rank's written blobs for
    its ring neighbour. ``written`` is the rank's checksum table, the
    digests a puller verifies against. Base-referenced (``../``)
    locations belong to other steps and are skipped; chunk refs are this
    step's payload and push (or dedup). A no-op unless the tier is
    configured; never raises."""
    global _WARNED_NO_CHECKSUMS
    if not knobs.is_peer_tier_enabled():
        return None
    rep = _live_replicator()
    if rep is None:
        return None
    try:
        blobs = {p: tuple(e) for p, e in written.items() if not p.startswith("../") or _is_chunk(p)}
        if not blobs:
            if knobs.is_checksums_disabled() and not _WARNED_NO_CHECKSUMS:
                # The inventory is the checksum table: with checksums off
                # there is nothing to push. Said once, so that a tier that
                # is on but inert is found before the preemption it failed
                # to insure.
                _WARNED_NO_CHECKSUMS = True
                logger.warning(
                    "peer tier: checksums are disabled (TORCHSNAPSHOT_TPU_DISABLE_CHECKSUMS), so no "
                    "blob inventory exists to push; the peer tier is inert and a preemption "
                    "restores from storage"
                )
            return None
        return rep.enqueue_push(path, blobs, committed=committed, step=step_from_path(peer_step_key(path)))
    except Exception as e:  # noqa: BLE001 - the tier degrades, never fails a take
        logger.warning("peer tier: push enqueue failed: %r", e)
        return None


def maybe_drain(timeout: Optional[float] = None) -> bool:
    """Flush pending pushes; True when all settled or the tier is inert."""
    rep = _live_replicator()
    return True if rep is None else rep.drain(timeout)


def maybe_evict_step(path: str) -> None:
    """The manager's GC hook (rank 0): evict a dropped step's peer copies
    from every advertised endpoint, on a detached daemon thread (a dead
    peer's timeouts must never stretch a save). The caches bound
    themselves anyway; this reclaims the RAM promptly."""
    rep = _live_replicator()
    if rep is None:
        return
    step_key = peer_step_key(path)
    timeout = min(5.0, knobs.get_peer_transfer_timeout_seconds())
    world = rep.world_size

    def _evict_all() -> None:
        for endpoint in rep.resolve_endpoints(range(world)).values():
            client = PeerClient(endpoint[0], endpoint[1], timeout=timeout)
            try:
                client.evict(step_key)
            except PeerTransferError:
                pass  # a dead peer: its cache died with it
            finally:
                client.close()

    threading.Thread(target=_evict_all, name="peer-tier-evict", daemon=True).start()


def peer_state_for_path(path: str) -> Optional[Dict[str, Any]]:
    """The replicator's state when the tier is configured, else None."""
    rep = _live_replicator()
    return None if rep is None else rep.state()


# ---------------------------------------------------------------------------
# Restore side: the tier ladder
# ---------------------------------------------------------------------------


class PeerRestoreContext:
    """One restore's peer state: the owner table over the surviving peers
    (blob path -> (rank, endpoint, integrity entry)) and the per-tier byte
    accounting that ``restore_telemetry`` carries as ``tier_split``."""

    def __init__(
        self, table: Dict[str, Tuple[int, Tuple[str, int], tuple]], step_key: str, timeout: Optional[float] = None
    ) -> None:
        self.table = table
        self.step_key = step_key
        self.timeout = timeout if timeout is not None else knobs.get_peer_transfer_timeout_seconds()
        self._lock = threading.Lock()
        # A pool of free connections per endpoint: concurrent pulls each
        # borrow one (dialling when none is free), so a restore's reads do
        # not queue on one stream per peer. A connection that failed is
        # closed, not returned.
        self._free_clients: Dict[Tuple[str, int], List[PeerClient]] = {}
        self._endpoint_failures: Dict[Tuple[str, int], int] = {}
        self.tier_bytes: Dict[str, int] = {"peer": 0, "fast": 0, "durable": 0}
        self.peer_failures = 0
        self.fallthrough_bytes = 0
        self.served_blobs = 0

    @property
    def eligible_blobs(self) -> int:
        return len(self.table)

    def _borrow(self, endpoint: Tuple[str, int]) -> Optional[PeerClient]:
        with self._lock:
            if self._endpoint_failures.get(endpoint, 0) >= _PULL_DEAD_AFTER_FAILURES:
                return None
            free = self._free_clients.get(endpoint)
            if free:
                return free.pop()
        return PeerClient(endpoint[0], endpoint[1], timeout=self.timeout)

    def _give_back(self, endpoint: Tuple[str, int], client: PeerClient) -> None:
        with self._lock:
            self._free_clients.setdefault(endpoint, []).append(client)

    def entry_of(self, path: str) -> Optional[tuple]:
        owner = self.table.get(path)
        return None if owner is None else tuple(owner[2])

    def pull(self, path: str, byte_range: Optional[Tuple[int, int]] = None) -> Optional[bytes]:
        """The digest-verified bytes of ``path`` (the whole blob, or exactly
        ``byte_range``) from its owning peer, or None on any failure (the
        caller falls through a tier). A ranged read of a blob with page
        digests is sliced on the server and verified through the pages it
        covers; a window that covers no whole page, or a blob with only a
        whole-blob digest, takes one whole-blob transfer, verified, and is
        sliced here: no byte is trusted unverified."""
        owner = self.table.get(path)
        if owner is None:
            return None
        _, endpoint, entry = owner
        client = self._borrow(endpoint)
        if client is None:
            return None
        entry = tuple(entry)
        rng = None if byte_range is None else (int(byte_range[0]), int(byte_range[1]))
        ranged = rng is not None and len(entry) >= 5
        try:
            with _trace_recorder().span(metric_names.SPAN_PEER_PULL, blob=path):
                found = client.pull(self.step_key, path, rng if ranged else None)
                if found is not None and ranged:
                    from ..integrity import verify_range_checksum

                    if not verify_range_checksum(found[1], entry, rng, path):
                        # No whole page in the window: re-pull the blob so
                        # that its full digest can vouch.
                        found = client.pull(self.step_key, path)
                        ranged = False
            if found is None:
                # A stale step or an evicted blob: a correct miss.
                self._give_back(endpoint, client)
                with self._lock:
                    self.peer_failures += 1
                return None
            data = found[1]
            # Verified against the entry recorded at write time (the
            # inventory the table came from): a corrupted cache, or a peer
            # echoing another step's bytes, never reaches a destination.
            if not ranged:
                verify_checksum(data, entry, path)
            self._give_back(endpoint, client)
            with self._lock:
                self._endpoint_failures.pop(endpoint, None)
            return data[rng[0] : rng[1]] if rng is not None and not ranged else data
        except ChecksumError as e:
            logger.warning("peer tier: checksum mismatch pulling %s (%r); falling through", path, e)
            # The transport is fine, only the bytes are wrong: the
            # connection goes back, the endpoint does not count down.
            self._give_back(endpoint, client)
            with self._lock:
                self.peer_failures += 1
            return None
        except PeerTransferError as e:
            client.close()
            with self._lock:
                self.peer_failures += 1
                n = self._endpoint_failures[endpoint] = self._endpoint_failures.get(endpoint, 0) + 1
            logger.warning(
                "peer tier: pull of %s from %s failed (%r, failure %d); falling through", path, endpoint, e, n
            )
            return None

    def count(self, tier: str, nbytes: int) -> None:
        with self._lock:
            self.tier_bytes[tier] = self.tier_bytes.get(tier, 0) + int(nbytes)
            if tier == "peer":
                self.served_blobs += 1

    def discount(self, tier: str, nbytes: int) -> None:
        """Take back a serve that verification rejected (the healing
        ladder re-served the blob from another tier): the split sums to
        the bytes restored, not to those plus every corrupt attempt."""
        with self._lock:
            self.tier_bytes[tier] = max(0, self.tier_bytes.get(tier, 0) - int(nbytes))

    def note_fallthrough(self, nbytes: int) -> None:
        with self._lock:
            self.fallthrough_bytes += int(nbytes)

    def pipeline_fields(self) -> Dict[str, Any]:
        """The restore's peer fields: the per-tier byte split and the
        degradation evidence (the JAX package's ``peer-tier-degraded``
        doctor rule reads the same fields of its restore report)."""
        with self._lock:
            return {
                "tier_split": dict(self.tier_bytes),
                "peer": {
                    "eligible_blobs": self.eligible_blobs,
                    "served_blobs": self.served_blobs,
                    "failures": self.peer_failures,
                    "fallthrough_bytes": self.fallthrough_bytes,
                    "degraded": bool(self.peer_failures or self.fallthrough_bytes),
                },
            }

    def wrap(self, storage: StoragePlugin) -> StoragePlugin:
        return _PeerLadderPlugin(storage, self)

    def close(self) -> None:
        with self._lock:
            pools, self._free_clients = self._free_clients, {}
        for clients in pools.values():
            for client in clients:
                client.close()


def _nbytes(read_io: ReadIO) -> int:
    return memoryview(read_io.buf).nbytes if read_io.buf is not None else 0


class _PeerLadderPlugin(StoragePlugin):
    """The per-blob ladder as a plugin view: the local fast tier, then
    peer RAM for table-resident blobs, then durable, with per-tier byte
    accounting. It stands in for the restore's plugin wholesale, so
    ``close`` closes the inner plugin too."""

    def __init__(self, inner: StoragePlugin, ctx: PeerRestoreContext) -> None:
        from .plugin import TieredStoragePlugin

        self.inner = inner
        self.ctx = ctx
        self._tiered = inner if isinstance(inner, TieredStoragePlugin) else None

    async def read(self, read_io: ReadIO) -> None:
        path = read_io.path
        eligible = path in self.ctx.table
        # A local fast-tier copy is free: shipping it over the wire would
        # multiply restore traffic by the world for nothing. (A
        # replacement rank's fast tier is empty, so it goes peer first.)
        if self._tiered is not None:
            try:
                await self._tiered.fast.read(read_io)
                read_io.served_by = "fast"
                self.ctx.count("fast", _nbytes(read_io))
                return
            except FileNotFoundError:
                pass
        if eligible:
            loop = asyncio.get_running_loop()
            chunk = await loop.run_in_executor(None, self.ctx.pull, path, read_io.byte_range)
            if chunk is not None:
                if read_io.dest is not None and len(read_io.dest) == len(chunk):
                    read_io.dest[:] = chunk
                    read_io.buf = read_io.dest
                else:
                    read_io.buf = memoryview(chunk)
                read_io.served_by = "peer"
                read_io.verified_entry = self.ctx.entry_of(path)
                self.ctx.count("peer", len(chunk))
                return
        # The bottom of the ladder: durable storage (a plain inner plugin
        # is the durable tier).
        await (self._tiered.durable if self._tiered is not None else self.inner).read(read_io)
        read_io.served_by = "durable"
        nbytes = _nbytes(read_io)
        self.ctx.count("durable", nbytes)
        if eligible:
            # A peer copy existed but storage served it: the degradation.
            self.ctx.note_fallthrough(nbytes)

    async def read_degraded(self, read_io: ReadIO) -> bool:
        """The healing ladder's hook: peer pulls are verified inside
        :meth:`PeerRestoreContext.pull`, so only the storage tiers can
        hand verification corrupt bytes; retry whichever of durable and
        fast has not served this request yet."""
        tried = getattr(read_io, "_tiers_tried", None)
        if tried is None:
            tried = read_io._tiers_tried = {read_io.served_by} if read_io.served_by else set()
        # The rejected serve was counted: take it back.
        if read_io.served_by and read_io.buf is not None:
            self.ctx.discount(read_io.served_by, _nbytes(read_io))
        if self._tiered is not None:
            tiers = [("durable", self._tiered.durable), ("fast", self._tiered.fast)]
        else:
            tiers = [("durable", self.inner)]
        for tier, plugin in tiers:
            if tier in tried:
                continue
            tried.add(tier)
            try:
                await plugin.read(read_io)
            except (FileNotFoundError, OSError):
                continue
            read_io.served_by = tier
            read_io.verified_entry = None
            self.ctx.count(tier, _nbytes(read_io))
            return True
        return False

    async def read_with_checksum(self, read_io: ReadIO):
        return None  # declined (sticky): every read goes through the ladder

    async def write(self, write_io: WriteIO) -> None:
        await self.inner.write(write_io)

    async def write_with_checksum(self, write_io: WriteIO):
        return await self.inner.write_with_checksum(write_io)

    async def delete(self, path: str) -> None:
        await self.inner.delete(path)

    async def close(self) -> None:
        self.ctx.close()
        await self.inner.close()


def build_restore_context(path: str) -> Optional[PeerRestoreContext]:
    """The restore's owner table for one snapshot path: every advertised
    endpoint (one batched registry read) is asked for its inventory of the
    step, concurrently; a dead peer is skipped with a warning. None when
    the tier is off or inert or no peer holds anything of the step: the
    restore then runs exactly the path without peers. Never raises."""
    if not knobs.is_peer_tier_enabled():
        return None
    rep = _live_replicator()
    if rep is None:
        return None
    try:
        from concurrent.futures import ThreadPoolExecutor

        step_key = peer_step_key(path)
        timeout = knobs.get_peer_transfer_timeout_seconds()
        endpoints = rep.resolve_endpoints(range(rep.world_size))

        def _inventory_of(rank: int):
            endpoint = endpoints.get(rank)
            if endpoint is None:
                return rank, None, {}
            client = PeerClient(endpoint[0], endpoint[1], timeout=timeout)
            try:
                return rank, endpoint, client.list_step(step_key)
            except PeerTransferError as e:
                logger.warning(
                    "peer tier: rank %d endpoint %s unreachable during restore setup (%r); its "
                    "cached blobs fall through to storage",
                    rank, endpoint, e,
                )
                return rank, endpoint, {}
            finally:
                client.close()

        # Concurrent: a setup costs one timeout, not world timeouts, when
        # stale endpoints of preempted hosts linger in the registry.
        with ThreadPoolExecutor(max_workers=min(8, max(1, rep.world_size)), thread_name_prefix="peer-tier-inv") as pool:
            results = list(pool.map(_inventory_of, range(rep.world_size)))
        table: Dict[str, Tuple[int, Tuple[str, int], tuple]] = {}
        for rank, endpoint, inventory in results:
            if endpoint is None:
                continue
            for blob_path, entry in inventory.items():
                table.setdefault(blob_path, (rank, endpoint, tuple(entry)))
        if not table:
            return None
        return PeerRestoreContext(table, step_key, timeout=timeout)
    except Exception as e:  # noqa: BLE001 - degrade to a storage-only restore
        logger.warning("peer tier: restore-context build failed: %r", e)
        return None
