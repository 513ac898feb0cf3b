"""Single-reader fan-out restore: one storage read per unique saved shard.

Counterpart of ``torchsnapshot_tpu/fanout.py``, with the same exchange
protocol. Without fan-out every restoring process pulls its bytes from
storage itself: N processes pay N reads per shard. With it each unique
byte window is read once and distributed over the coordination store.

Topology: a deterministic **owner table**
(``resharding.assign_shard_owners`` over the manifest's eligible shard
blobs, ``manifest.sharded_blob_windows``: a content hash of the committed
manifest, so every rank derives the same table from the same metadata
file; whether fan-out runs at all is rank 0's knob, broadcast at restore
start) maps each unique saved-shard blob to one owner rank. Per restore
round (one per stateful key in the sync path, one covering every plan in
the async path) the ranks exchange their needed byte windows, each owner
issues one ranged read of the union window per owned and needed blob,
and the bytes ride round-scoped store keys to the ranks that need them.
The read pipeline then runs unchanged against a :class:`StoragePlugin`
wrapper that serves those blobs from the exchanged cache and passes
everything else (metadata, checksum tables, dense and object blobs) to
the real plugin.

The exchange does not use the ``PGWrapper`` collectives, whose op
sequence is shared: every key sits under the round's nonce prefix, so a
rank that dies mid-restore cannot leave the sequence half advanced.
Every wait polls the round's **error key** (``{prefix}/error``, which the
round's barrier poisons through ``report_error``), so a peer failing in
planning, fetching or setup aborts the exchange within seconds; a failing
owner read raises on every rank, and a failed round leaves no key behind.

Each round runs inside one ``wire.propagate(RPC_FANOUT_EXCHANGE)``: every
store frame of its needs gather and blob exchange carries the same trace
id.

Kill switch: ``TORCHSNAPSHOT_TPU_FANOUT_RESTORE=0`` (rank 0's reading)
restores every-rank-reads.
"""

from __future__ import annotations

import asyncio
import logging
import pickle
import time
from typing import Any, Dict, List, Optional, Tuple

from . import knobs, telemetry
from .dist_store import Store, StoreTimeoutError, _PollPacer, scaled_poll_cap
from .io_types import ReadIO, ReadReq, StoragePlugin, WriteIO
from .manifest import Manifest, sharded_blob_windows
from .resharding import assign_shard_owners
from .telemetry import wire as _wire
from .telemetry.trace import get_recorder as _trace_recorder

logger: logging.Logger = logging.getLogger(__name__)

_DEFAULT_TIMEOUT_S = 300.0


class FanoutError(RuntimeError):
    """A fan-out round failed on some rank; every participant raises."""


class FanoutRestoreContext:
    """One restore's fan-out state: the owner table, the per-round byte
    cache, and the fetched/received byte accounting that feeds the
    restore report's ``bytes_fetched``/``bytes_received``."""

    def __init__(
        self,
        owners: Dict[str, int],
        windows: Dict[str, Tuple[int, int]],
        store: Optional[Store],
        rank: int,
        world_size: int,
    ) -> None:
        self.owners = owners
        self.windows = windows
        self.store = store
        self.rank = rank
        self.world_size = world_size
        # location -> ((lo, hi) cached window, bytes) for the current
        # round(s); served through wrap()'s plugin.
        self.cache: Dict[str, Tuple[Tuple[int, int], bytes]] = {}
        # This rank's bytes pulled from the storage plugin as an owner,
        # received from peer owners for its own needs, published for its
        # peers, and served to its read pipeline from the cache.
        self.bytes_fetched = 0
        self.bytes_received = 0
        self.bytes_published = 0
        self.bytes_served = 0
        # The snapshot's checksum table, set by the restore before the
        # exchange: an owner verifies each fetched window against it and
        # heals a corrupt one from another copy (a tiered root's durable
        # tier) before publishing, so that no peer receives bad bytes.
        self.checksum_table: Optional[Dict[str, Any]] = None
        # The owner-side healed reads (scheduler.heal_read's counters).
        from .scheduler import _PipelineStats

        self.heal_stats = _PipelineStats()

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def build(cls, manifest: Manifest, pg_wrapper: Any) -> "FanoutRestoreContext":
        """Derive the owner table from the committed global manifest.
        Pure content-deterministic computation — every rank reads the
        same metadata file, so every rank derives the same table without
        a world-sized broadcast; the *enablement* decision is what gets
        broadcast (rank 0's knob, agreed at restore start)."""
        windows = sharded_blob_windows(manifest)
        owners = assign_shard_owners(windows, pg_wrapper.get_world_size())
        return cls(
            owners,
            windows,
            pg_wrapper.store,
            pg_wrapper.get_rank(),
            pg_wrapper.get_world_size(),
        )

    # ------------------------------------------------------------------
    # the exchange round
    # ------------------------------------------------------------------

    def _needs_for(self, read_reqs: List[ReadReq]) -> Dict[str, Tuple[int, int]]:
        """Union byte window per fan-out-eligible blob this rank's reads
        touch (the preparer plans one contiguous row band per saved
        shard, so the union window is what the owner fetches)."""
        needs: Dict[str, Tuple[int, int]] = {}
        for req in read_reqs:
            full = self.windows.get(req.path)
            if full is None:
                continue
            rng = req.byte_range if req.byte_range is not None else full
            lo, hi = needs.get(req.path, rng)
            needs[req.path] = (min(lo, int(rng[0])), max(hi, int(rng[1])))
        return needs

    def _poll(self, key: str, error_key: str, timeout: float) -> bytes:
        """Wait for ``key``, aborting fast if any peer poisons the
        round's error key (the barrier ``report_error`` channel the
        enclosing ``_reporting_to`` writes on failure). Error key and
        data key ride ONE batched round trip per tick, with the shared
        exponential poll backoff."""
        out: Dict[str, bytes] = {}
        self._poll_all([key], error_key, timeout, out.__setitem__)
        return out[key]

    def _poll_all(
        self,
        keys: List[str],
        error_key: str,
        timeout: float,
        consume,
    ) -> None:
        """Batched wait for EVERY key in ``keys``: one ``multi_get``
        round trip per tick over the error key plus the still-missing
        keys — a thousand-rank needs-gather costs the leader one
        request per tick, not world sequential scans — calling
        ``consume(key, value)`` as each key lands (arrival order, so
        owner-published windows are consumed while stragglers publish).
        """
        assert self.store is not None
        pending = list(keys)
        deadline = time.monotonic() + timeout
        pacer = _PollPacer(cap=scaled_poll_cap(self.world_size))
        while pending:
            got = self.store.multi_get([error_key] + pending)
            err = got.get(error_key)
            if err is not None:
                exc = pickle.loads(err)
                raise FanoutError(
                    f"rank {self.rank}: a peer reported an error into the "
                    f"fan-out round ({error_key!r})"
                ) from exc
            still: List[str] = []
            for key in pending:
                val = got.get(key)
                if val is None:
                    still.append(key)
                else:
                    consume(key, val)
            if not still:
                return
            if len(still) < len(pending):
                pacer.reset()  # progress: keep first-poll latency low
            pending = still
            if time.monotonic() > deadline:
                raise StoreTimeoutError(
                    f"rank {self.rank} timed out in fan-out exchange "
                    f"waiting for {pending[:3]!r}"
                    + (f" (+{len(pending) - 3} more)" if len(pending) > 3 else "")
                )
            pacer.sleep(deadline)

    def exchange(
        self,
        read_reqs: List[ReadReq],
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        rendezvous_prefix: str,
        timeout: float = _DEFAULT_TIMEOUT_S,
    ) -> List[str]:
        """One fan-out round under ``rendezvous_prefix`` (the round's
        error-aware barrier prefix — data keys nest beneath it, and
        every wait polls its error key). MUST run on every rank, in the
        same round order, on the thread that owns collective ordering —
        pass an empty ``read_reqs`` when this rank loads nothing this
        round. Returns the locations cached for this rank (for
        :meth:`drop`)."""
        assert self.store is not None
        t0 = time.monotonic()
        span = _trace_recorder().begin(
            telemetry.names.SPAN_FANOUT_EXCHANGE,
            prefix=rendezvous_prefix,
            rank=self.rank,
            world=self.world_size,
            reqs=len(read_reqs),
        )
        try:
            # One wire context for the whole round: the merged trace shows
            # its store frames as one tree.
            with _wire.propagate(telemetry.names.RPC_FANOUT_EXCHANGE):
                return self._exchange_impl(
                    read_reqs, storage, event_loop, rendezvous_prefix, timeout
                )
        finally:
            _trace_recorder().end(span)
            try:
                telemetry.metrics().counter_inc(
                    telemetry.names.COORD_EXCHANGE_SECONDS_TOTAL,
                    time.monotonic() - t0,
                )
            except Exception:  # noqa: BLE001 - telemetry is best-effort
                pass

    def _exchange_impl(
        self,
        read_reqs: List[ReadReq],
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        rendezvous_prefix: str,
        timeout: float = _DEFAULT_TIMEOUT_S,
    ) -> List[str]:
        p = f"{rendezvous_prefix}/fanout"
        error_key = f"{rendezvous_prefix}/error"
        needs = self._needs_for(read_reqs)

        # Needs gather, rank 0 aggregating (the Store.exchange shape,
        # re-built here so every wait is error-aware and every key is
        # round-scoped): each rank publishes its needs; rank 0 combines
        # the FULL table and republishes it as one doc; everyone reads
        # the combined doc. Batched end to end: rank 0 polls every
        # peer's needs key in one multi_get round trip per tick (not a
        # per-peer sequential scan) and tears the per-rank keys down
        # with one multi_delete — O(1) round trips per rank per round.
        if self.rank == 0:
            peer_keys = [
                f"{p}/needs/{peer}" for peer in range(1, self.world_size)
            ]
            by_key: Dict[str, Dict[str, Tuple[int, int]]] = {}
            self._poll_all(
                peer_keys,
                error_key,
                timeout,
                lambda k, v: by_key.__setitem__(k, pickle.loads(v)),
            )
            if peer_keys:
                self.store.multi_delete(peer_keys)
            gathered: List[Dict[str, Tuple[int, int]]] = [needs] + [
                by_key[k] for k in peer_keys
            ]
            self.store.set(f"{p}/needs/__all", pickle.dumps(gathered))
        else:
            self.store.set(f"{p}/needs/{self.rank}", pickle.dumps(needs))
            gathered = pickle.loads(
                self._poll(f"{p}/needs/__all", error_key, timeout)
            )
        if self.store.add(f"{p}/needs/__all_done", 1) == self.world_size:
            self.store.multi_delete(
                [f"{p}/needs/__all", f"{p}/needs/__all_done"]
            )

        union: Dict[str, Tuple[int, int]] = {}
        needy: Dict[str, List[int]] = {}
        for peer, peer_needs in enumerate(gathered):
            for loc, (lo, hi) in peer_needs.items():
                cur = union.get(loc, (lo, hi))
                union[loc] = (min(cur[0], lo), max(cur[1], hi))
                needy.setdefault(loc, []).append(peer)

        locs = sorted(union)
        cached: List[str] = []

        # Phase A — owners fetch every owned-and-needed blob
        # CONCURRENTLY (one contiguous union-window ranged read each,
        # I/O-concurrency bounded) and publish each needy peer's OWN
        # sub-window the moment its read lands. Serializing these
        # fetches would convoy the whole fleet behind one owner's
        # serial storage latency; shipping the full union to every
        # consumer would scale coordinator traffic and per-rank cache
        # with the union instead of each rank's need.
        owned = [
            (idx, loc)
            for idx, loc in enumerate(locs)
            if self.owners[loc] == self.rank
        ]
        # Every "ok" window this rank publishes for its consumers. On a
        # failing round consumers abort through the error key without
        # reading their windows, so the publisher must reap them — blob
        # payloads are the round's big bytes, and an orphaned window
        # outlives the round in the store.
        published_ok: List[str] = []
        if owned:
            io_slots = asyncio.Semaphore(
                max(1, knobs.get_per_rank_io_concurrency())
            )

            async def _fetch_one(idx: int, loc: str) -> None:
                lo, hi = union[loc]
                consumers = [r for r in needy[loc] if r != self.rank]
                try:
                    async with io_slots:
                        read_io = ReadIO(path=loc, byte_range=(lo, hi))
                        await storage.read(read_io)
                        if read_io.buf is None:
                            raise RuntimeError(
                                f"storage plugin {type(storage).__name__} "
                                f"completed read() without populating the "
                                f"buffer for {loc!r}"
                            )
                        await self._verify_or_heal(storage, read_io)
                    data = bytes(read_io.buf)
                except BaseException as e:  # noqa: BLE001 - ship to peers
                    # The error rides the data channel itself (on top
                    # of the barrier error key the caller will poison),
                    # so consumers already polling this blob abort now.
                    # One batched publication for all consumers.
                    if consumers:
                        marker = pickle.dumps(("error", None, repr(e)))
                        self.store.multi_set(
                            {
                                f"{p}/blob/{idx}/{peer}": marker
                                for peer in consumers
                            }
                        )
                    raise
                self.bytes_fetched += len(data)
                # One multi_set round trip publishes every needy peer's
                # sub-window for this blob — per-key sets would cost the
                # owner O(consumers) sequential round trips per blob.
                payloads: Dict[str, bytes] = {}
                for peer in consumers:
                    plo, phi = gathered[peer][loc]
                    payloads[f"{p}/blob/{idx}/{peer}"] = pickle.dumps(
                        ("ok", (plo, phi), data[plo - lo : phi - lo])
                    )
                if payloads:
                    self.store.multi_set(payloads)
                    published_ok.extend(payloads)
                    self.bytes_published += sum(
                        gathered[peer][loc][1] - gathered[peer][loc][0]
                        for peer in consumers
                    )
                if loc in needs:
                    self.cache[loc] = ((lo, hi), data)

            async def _fetch_owned() -> None:
                results = await asyncio.gather(
                    *(_fetch_one(idx, loc) for idx, loc in owned),
                    return_exceptions=True,
                )
                errors = [r for r in results if isinstance(r, BaseException)]
                if errors:
                    # Every owned blob settled (data or error marker on
                    # the wire) before the first failure surfaces. The
                    # round is now failing: reap the windows this rank
                    # already published — its consumers abort via the
                    # markers/error key and will never read them. The
                    # markers themselves stay: they ARE the fail-fast
                    # channel, and whoever consumes one deletes it.
                    if published_ok:
                        try:
                            self.store.multi_delete(published_ok)
                        except Exception:  # noqa: BLE001 - best effort
                            pass
                    raise errors[0]

            event_loop.run_until_complete(_fetch_owned())
            cached.extend(loc for _, loc in owned if loc in needs)

        # Phase B — consume what peers own for us. Strictly this rank's
        # sub-windows: one key per (blob, consumer), polled as ONE
        # batched multi_get per tick (consumed in arrival order, so a
        # fast owner's windows land while a slow one still fetches) and
        # torn down with one multi_delete — nothing lingers in the
        # store and received bytes equal this rank's actual needs.
        awaited: Dict[str, str] = {}
        for idx, loc in enumerate(locs):
            if self.owners[loc] == self.rank or loc not in needs:
                continue
            awaited[f"{p}/blob/{idx}/{self.rank}"] = loc

        consumed: List[str] = []

        def _consume(key: str, raw: bytes) -> None:
            consumed.append(key)
            loc = awaited[key]
            status, window, data = pickle.loads(raw)
            if status == "error":
                raise FanoutError(
                    f"fan-out restore owner rank {self.owners[loc]} failed "
                    f"to fetch {loc!r}: {data}"
                )
            self.bytes_received += len(data)
            self.cache[loc] = (tuple(window), data)
            cached.append(loc)

        if awaited:
            try:
                self._poll_all(list(awaited), error_key, timeout, _consume)
            except BaseException:
                # The round is failing (a peer's error marker or the
                # poisoned error key). Tear down what we read AND what
                # we published — our consumers are aborting through the
                # same error key and will never read their windows.
                teardown = consumed + published_ok
                if teardown:
                    try:
                        self.store.multi_delete(teardown)
                    except Exception:  # noqa: BLE001 - best effort
                        pass
                raise
            # Tear down what we actually read (an owner's error marker
            # is consumed too); keys we never saw stay for their owner —
            # the round is nonce-scoped either way.
            if consumed:
                self.store.multi_delete(consumed)
        return cached

    async def _verify_or_heal(self, storage: StoragePlugin, read_io: ReadIO) -> None:
        """Verify an owner's fetched window against the checksum table
        (every page it covers fully) and heal it through the plugin's
        ladder on a mismatch; raise when no copy verifies."""
        entry = self.checksum_table.get(read_io.path) if self.checksum_table else None
        from .scheduler import heal_read, verified_by_plugin

        if entry is None or verified_by_plugin(read_io, entry):
            return  # nothing to verify against, or the peer ladder did
        from .integrity import ChecksumError, verify_checksum, verify_range_checksum

        lo, hi = read_io.byte_range
        whole = lo == 0 and hi == entry[2]

        def check(buf) -> None:
            if whole:
                verify_checksum(buf, entry, read_io.path)
            else:
                verify_range_checksum(buf, entry, read_io.byte_range, read_io.path)

        async def verify(buf) -> None:
            await asyncio.get_running_loop().run_in_executor(None, check, buf)

        try:
            await verify(read_io.buf)
        except ChecksumError as first_err:
            await heal_read(storage, read_io, verify, first_err, self.heal_stats)

    def drop(self, locations: List[str]) -> None:
        """Release a round's cached bytes once its pipeline consumed
        them (sync restores drop per stateful key; async restores hold
        the whole plan's cache until the background reads finish)."""
        for loc in locations:
            self.cache.pop(loc, None)

    def clear(self) -> None:
        self.cache.clear()

    # ------------------------------------------------------------------
    # read-pipeline integration
    # ------------------------------------------------------------------

    def wrap(self, storage: StoragePlugin) -> StoragePlugin:
        """A plugin view serving cached fan-out blobs and delegating the
        rest; hand this to the read pipeline in place of ``storage``."""
        return _FanoutStoragePlugin(storage, self)


class _FanoutStoragePlugin(StoragePlugin):
    """Serves reads of exchanged shard blobs from the fan-out cache;
    every other operation delegates to the wrapped plugin. Close is NOT
    delegated — the restore owns the real plugin's lifecycle."""

    def __init__(self, inner: StoragePlugin, ctx: FanoutRestoreContext) -> None:
        self.inner = inner
        self.ctx = ctx

    async def read(self, read_io: ReadIO) -> None:
        entry = self.ctx.cache.get(read_io.path)
        if entry is None:
            await self.inner.read(read_io)
            return
        (lo, hi), data = entry
        rng = read_io.byte_range
        if rng is None:
            rng = self.ctx.windows[read_io.path]
        a, b = int(rng[0]), int(rng[1])
        if a < lo or b > hi:
            raise FanoutError(
                f"fan-out cache for {read_io.path!r} holds [{lo}, {hi}) "
                f"but the read wants [{a}, {b}) — the exchanged union "
                f"window missed a request (planning bug)"
            )
        chunk = data[a - lo : b - lo]
        self.ctx.bytes_served += len(chunk)
        if read_io.dest is not None and len(read_io.dest) == len(chunk):
            read_io.dest[:] = chunk
            read_io.buf = read_io.dest
        else:
            read_io.buf = memoryview(chunk)
        read_io.served_by = "fanout-cache"

    async def read_degraded(self, read_io: ReadIO) -> bool:
        """Corruption fallthrough: a cache-served blob whose exchanged
        bytes fail verification re-reads from real storage directly
        (the owner's fetch — or the wire — damaged them); everything
        else walks the wrapped plugin's own ladder."""
        if read_io.served_by == "fanout-cache":
            read_io.served_by = None
            await self.inner.read(read_io)
            if read_io.served_by is None:
                read_io.served_by = "storage"
            return True
        return await self.inner.read_degraded(read_io)

    async def write(self, write_io: WriteIO) -> None:  # pragma: no cover
        await self.inner.write(write_io)

    async def delete(self, path: str) -> None:  # pragma: no cover
        await self.inner.delete(path)

    async def close(self) -> None:
        # The wrapped plugin outlives this view; nothing to release.
        return None
