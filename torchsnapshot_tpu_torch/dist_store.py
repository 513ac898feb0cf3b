"""Process-coordination store: KV primitives, object collectives, barriers.

Counterpart of ``torchsnapshot_tpu/dist_store.py``. Snapshot coordination
moves only metadata between ranks (manifests, write plans, error reports,
step numbers), never tensor bytes, so it rides a small socket KV store
rather than NCCL: two ranks can even share one card. This module provides:

- :class:`Store`: the primitive interface (set / try_get / add / delete,
  batched ``multi_*``) plus the object collectives built on it
  (``exchange``, ``gather``, ``broadcast``, ``scatter``, ``barrier``);
- :class:`TCPStore`: a self-contained socket KV server hosted by one rank,
  and :class:`InProcessStore` for thread-based tests;
- :class:`ShardedStore` and :func:`bootstrap_sharded_store`: N member
  stores behind deterministic key->shard hashing;
- :class:`LinearBarrier` and :class:`TreeBarrier`: two-phase
  (arrive / depart) barriers with error propagation, safe to use off the
  main thread (the async take's commit thread); :func:`make_barrier`
  picks one (``TORCHSNAPSHOT_TPU_TREE_BARRIER=0`` is the kill switch);
- :func:`torch_process_group`: the process group of a ``torch.distributed``
  job (an initialized default group, or torchrun's environment), with this
  package's TCPStore bootstrapped through the c10d store.

Every wait loop backs off exponentially (:class:`_PollPacer`, cap ~100 ms),
and store requests feed the ``coordination_store_*`` counters; barrier
waits feed ``coordination_barrier_wait_seconds_total`` and the
``barrier:*`` spans. Collective keys are transient: the last participant
to finish an operation deletes them, so a long-lived store does not leak.
"""

from __future__ import annotations

import abc
import os
import pickle
import socket
import socketserver
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from . import knobs

_DEFAULT_TIMEOUT_S = 300.0
_POLL_INTERVAL_S = 0.005
_POLL_CAP_S = 0.1
_CONNECT_TIMEOUT_S = 30.0

# Aggregate idle-poll budget a wait loop sizes its backoff cap against:
# cap ~ world / _POLL_QPS_BUDGET, clamped to [initial, _POLL_CAP_S]. A
# 2-rank barrier keeps ~5 ms detection latency; a 1000-rank one backs off
# to the 100 ms ceiling.
_POLL_QPS_BUDGET = 5000.0


def scaled_poll_cap(world_size: int) -> float:
    return min(_POLL_CAP_S, max(_POLL_INTERVAL_S, world_size / _POLL_QPS_BUDGET))


class _PollPacer:
    """Deadline-aware exponential poll backoff for store wait loops: the
    interval doubles per miss up to the cap, never sleeps past the
    caller's deadline, and ``reset`` returns to the first interval when a
    wait observes progress."""

    def __init__(self, initial: Optional[float] = None, cap: Optional[float] = None) -> None:
        self._initial = _POLL_INTERVAL_S if initial is None else initial
        self._delay = self._initial
        self._cap = _POLL_CAP_S if cap is None else cap

    def reset(self) -> None:
        self._delay = self._initial

    def sleep(self, deadline: Optional[float] = None) -> None:
        delay = self._delay
        if deadline is not None:
            delay = min(delay, max(0.0, deadline - time.monotonic()))
        if delay > 0:
            time.sleep(delay)
        self._delay = min(self._delay * 2.0, self._cap)


# ---------------------------------------------------------------------------
# Coordination telemetry (best-effort; never fails a collective)
# ---------------------------------------------------------------------------


def _tele_modules():
    """(telemetry package, names, trace), imported on first use: this
    module sits below the telemetry package in the import graph."""
    from . import telemetry
    from .telemetry import names, trace

    return telemetry, names, trace


def _observe_store_requests(op: str, seconds: float, requests: int = 1) -> None:
    """One store round trip's coordination accounting: the
    ``coordination_store_requests_total`` and ``..._seconds_total``
    counters, labelled by op."""
    try:
        telemetry, n, _ = _tele_modules()
        reg = telemetry.metrics()
        reg.counter_inc(n.COORD_STORE_REQUESTS_TOTAL, float(requests), op=op)
        reg.counter_inc(n.COORD_STORE_SECONDS_TOTAL, seconds, op=op)
    except Exception:  # noqa: BLE001 - telemetry must never break the store
        pass


@dataclass
class ProcessGroup:
    """What :class:`~torchsnapshot_tpu_torch.pg_wrapper.PGWrapper`
    consumes: a store plus this process's coordinates."""

    store: "Store"
    rank: int
    world_size: int
    # torch_process_group's side channel, kept alive with the group.
    c10d_store: Any = None


class StoreTimeoutError(TimeoutError):
    pass


class BarrierError(RuntimeError):
    """A peer reported an error into the barrier."""


_READ_GRACE_S = 5.0


class _TransientReads:
    """Tolerance tracker for deadline-bounded poll loops: a brief run of
    failed reads reads as "not yet", but a store failing continuously
    for longer than the grace re-raises (a dead TCPStore socket means the
    leader is gone; polling it until the deadline would mask a death)."""

    def __init__(self, grace: float = _READ_GRACE_S) -> None:
        self._grace = grace
        self._first_failure: Optional[float] = None

    def read(self, fn):
        """Run ``fn`` (a store read); None if it failed within grace."""
        try:
            out = fn()
        except Exception:
            now = time.monotonic()
            if self._first_failure is None:
                self._first_failure = now
            if now - self._first_failure > self._grace:
                raise
            return None
        self._first_failure = None
        return out


class Store(abc.ABC):
    """KV primitives and the object collectives derived from them."""

    # -- primitives -------------------------------------------------------

    @abc.abstractmethod
    def set(self, key: str, value: bytes) -> None: ...

    @abc.abstractmethod
    def try_get(self, key: str) -> Optional[bytes]:
        """The value, or None when the key is definitively absent. Raises
        on transport failures."""

    @abc.abstractmethod
    def add(self, key: str, amount: int) -> int:
        """Atomically add to an integer key (created at 0); returns the
        new value."""

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    # -- batched primitives (per-key loops unless a store has a wire
    # protocol that does one round trip per batch) ----------------------

    def multi_set(self, items: Dict[str, bytes]) -> None:
        for key, value in items.items():
            self.set(key, value)

    def multi_get(self, keys: Sequence[str]) -> Dict[str, Optional[bytes]]:
        return {key: self.try_get(key) for key in keys}

    def multi_delete(self, keys: Iterable[str]) -> None:
        for key in keys:
            self.delete(key)

    # -- blocking helpers -------------------------------------------------

    def get(
        self,
        key: str,
        timeout: float = _DEFAULT_TIMEOUT_S,
        poll_cap: Optional[float] = None,
    ) -> bytes:
        """Blocking read with exponential poll backoff, capped at
        ``poll_cap`` (callers that know the world size pass
        :func:`scaled_poll_cap`)."""
        deadline = time.monotonic() + timeout
        reads = _TransientReads()
        pacer = _PollPacer(cap=poll_cap)
        while True:
            val = reads.read(lambda: self.try_get(key))
            if val is not None:
                return val
            if time.monotonic() > deadline:
                raise StoreTimeoutError(f"Timed out waiting for store key {key!r}")
            pacer.sleep(deadline)

    def wait_any(self, keys: Sequence[str], timeout: float = _DEFAULT_TIMEOUT_S) -> Dict[str, bytes]:
        """Block until at least one of ``keys`` exists; returns all
        present (one batched round trip per poll)."""
        deadline = time.monotonic() + timeout
        reads = _TransientReads()
        pacer = _PollPacer()
        while True:
            got = reads.read(lambda: self.multi_get(list(keys)))
            present = {k: v for k, v in (got or {}).items() if v is not None}
            if present:
                return present
            if time.monotonic() > deadline:
                raise StoreTimeoutError(f"Timed out waiting for any of {keys!r}")
            pacer.sleep(deadline)

    # -- object collectives ----------------------------------------------

    def _cleanup(self, prefix: str, world_size: int, keys: List[str]) -> None:
        if self.add(f"{prefix}/__done", 1) == world_size:
            self.multi_delete(keys + [f"{prefix}/__done"])

    def exchange(
        self,
        prefix: str,
        rank: int,
        world_size: int,
        obj: Any,
        timeout: float = _DEFAULT_TIMEOUT_S,
    ) -> List[Any]:
        """All-gather of picklable objects. Rank 0 aggregates the per-rank
        blobs into one value that every other rank fetches with a single
        get: O(1) round trips per non-leader rank."""
        cap = scaled_poll_cap(world_size)
        self.set(f"{prefix}/{rank}", pickle.dumps(obj))
        if rank == 0:
            blobs = [self.get(f"{prefix}/{i}", timeout, poll_cap=cap) for i in range(world_size)]
            out = [pickle.loads(b) for b in blobs]
            self.set(f"{prefix}/__all", pickle.dumps(blobs))
        else:
            out = [
                pickle.loads(b)
                for b in pickle.loads(self.get(f"{prefix}/__all", timeout, poll_cap=cap))
            ]
        self._cleanup(
            prefix, world_size, [f"{prefix}/{i}" for i in range(world_size)] + [f"{prefix}/__all"]
        )
        return out

    def gather(
        self,
        prefix: str,
        rank: int,
        world_size: int,
        obj: Any,
        dst: int = 0,
        timeout: float = _DEFAULT_TIMEOUT_S,
    ) -> Optional[List[Any]]:
        """Gather picklable objects to ``dst`` (rank order); None
        elsewhere. Non-destination ranks publish their own blob and fetch
        nothing; the destination's own blob never touches the store."""
        blob = pickle.dumps(obj)
        out = None
        if rank == dst:
            cap = scaled_poll_cap(world_size)
            out = [
                pickle.loads(blob)
                if i == rank
                else pickle.loads(self.get(f"{prefix}/{i}", timeout, poll_cap=cap))
                for i in range(world_size)
            ]
        else:
            self.set(f"{prefix}/{rank}", blob)
        # Keys survive until every rank (dst included, which increments
        # only after reading all blobs) passed through _cleanup.
        self._cleanup(prefix, world_size, [f"{prefix}/{i}" for i in range(world_size)])
        return out

    def broadcast(
        self,
        prefix: str,
        rank: int,
        world_size: int,
        obj: Any,
        src: int = 0,
        timeout: float = _DEFAULT_TIMEOUT_S,
    ) -> Any:
        if rank == src:
            self.set(f"{prefix}/obj", pickle.dumps(obj))
            out = obj
        else:
            out = pickle.loads(
                self.get(f"{prefix}/obj", timeout, poll_cap=scaled_poll_cap(world_size))
            )
        self._cleanup(prefix, world_size, [f"{prefix}/obj"])
        return out

    def scatter(
        self,
        prefix: str,
        rank: int,
        world_size: int,
        objs: Optional[Sequence[Any]],
        src: int = 0,
        timeout: float = _DEFAULT_TIMEOUT_S,
    ) -> Any:
        if rank == src:
            assert objs is not None and len(objs) == world_size
            for i, o in enumerate(objs):
                self.set(f"{prefix}/{i}", pickle.dumps(o))
        out = pickle.loads(
            self.get(f"{prefix}/{rank}", timeout, poll_cap=scaled_poll_cap(world_size))
        )
        self._cleanup(prefix, world_size, [f"{prefix}/{i}" for i in range(world_size)])
        return out

    def barrier(
        self,
        prefix: str,
        rank: int,
        world_size: int,
        timeout: float = _DEFAULT_TIMEOUT_S,
    ) -> None:
        if self.add(f"{prefix}/arrive", 1) == world_size:
            self.set(f"{prefix}/go", b"1")
        else:
            self.get(f"{prefix}/go", timeout, poll_cap=scaled_poll_cap(world_size))
        if self.add(f"{prefix}/depart", 1) == world_size:
            for k in (f"{prefix}/arrive", f"{prefix}/go", f"{prefix}/depart"):
                self.delete(k)


# ---------------------------------------------------------------------------
# TCP store
# ---------------------------------------------------------------------------

_CMD_SET, _CMD_TRY_GET, _CMD_ADD, _CMD_DELETE = 0, 1, 2, 3
# Batched commands: one frame each way per batch; ``arg`` carries the
# key->value dict or the key list and the scalar ``key`` slot is "".
_CMD_MULTI_SET, _CMD_MULTI_GET, _CMD_MULTI_DELETE = 4, 5, 6

_CMD_OP_NAMES = {
    _CMD_SET: "set",
    _CMD_TRY_GET: "try_get",
    _CMD_ADD: "add",
    _CMD_DELETE: "delete",
    _CMD_MULTI_SET: "multi_set",
    _CMD_MULTI_GET: "multi_get",
    _CMD_MULTI_DELETE: "multi_delete",
}


# The chaos seam (``chaos/engine.py`` ``install_wire_chaos``): when set,
# every frame in both directions passes through the hook, which may fail,
# delay, corrupt or drop it. None in production.
_WIRE_CHAOS = None


def send_frame(sock: socket.socket, payload: bytes) -> None:
    """Length-prefixed frame write: the wire framing of the TCP store.
    (The JAX package's wire observatory, which counts these frames, is
    not ported.)"""
    hook = _WIRE_CHAOS
    if hook is not None:
        payload = hook("wire-send", payload)
        if payload is None:
            return  # a dropped frame: the receiver waits it out
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def recv_frame(sock: socket.socket) -> bytes:
    header = _recv_exact(sock, 4)
    (length,) = struct.unpack("<I", header)
    payload = _recv_exact(sock, length)
    hook = _WIRE_CHAOS
    if hook is not None:
        payload = hook("wire-recv", payload)
    return payload


# The JAX package's frame trace header (``telemetry/wire.py``): magic,
# version, reserved, a 24-byte op, trace and span ids, crc32. Its clients
# lead a frame with one inside a ``wire.propagate`` scope (a CDN sync, a
# fan-out exchange, a peer RPC).
_TRACE_MAGIC = b"TSWC"
_TRACE_HEADER_LEN = 4 + 1 + 1 + 24 + 8 + 8 + 4


def _strip_trace_header(payload: bytes) -> bytes:
    """A frame's body without the JAX package's trace header, when one
    leads it (a pickled request starts with the protocol byte, never
    with the magic). A torn header passes through, as there."""
    if payload[:4] == _TRACE_MAGIC and len(payload) >= _TRACE_HEADER_LEN:
        return payload[_TRACE_HEADER_LEN:]
    return payload


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(n)
        if not chunk:
            raise ConnectionError("store connection closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


class _StoreServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    # socketserver's default backlog of 5 overflows when a large world
    # connects at once.
    request_queue_size = 1024

    def __init__(self, addr) -> None:
        super().__init__(addr, _StoreRequestHandler)
        self.kv: Dict[str, bytes] = {}
        self.kv_lock = threading.Lock()


class _StoreRequestHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: _StoreServer = self.server  # type: ignore[assignment]
        try:
            while True:
                # A JAX client's frame may lead with a trace header.
                cmd, key, arg = pickle.loads(_strip_trace_header(recv_frame(self.request)))
                with server.kv_lock:
                    if cmd == _CMD_SET:
                        server.kv[key] = arg
                        reply = None
                    elif cmd == _CMD_TRY_GET:
                        reply = server.kv.get(key)
                    elif cmd == _CMD_ADD:
                        new = int(server.kv.get(key, b"0")) + arg
                        server.kv[key] = str(new).encode()
                        reply = new
                    elif cmd == _CMD_DELETE:
                        server.kv.pop(key, None)
                        reply = None
                    elif cmd == _CMD_MULTI_SET:
                        server.kv.update(arg)
                        reply = None
                    elif cmd == _CMD_MULTI_GET:
                        reply = {k: server.kv.get(k) for k in arg}
                    elif cmd == _CMD_MULTI_DELETE:
                        for k in arg:
                            server.kv.pop(k, None)
                        reply = None
                    else:  # pragma: no cover
                        raise ValueError(f"bad store command {cmd}")
                send_frame(self.request, pickle.dumps(reply))
        except (ConnectionError, EOFError):
            return


class TCPStore(Store):
    """Socket KV store; the hosting rank runs the server in a daemon
    thread and every rank (the host included) talks to it over one
    connection."""

    def __init__(
        self,
        host: str,
        port: int,
        is_server: bool,
        connect_timeout: float = _CONNECT_TIMEOUT_S,
    ) -> None:
        self._server: Optional[_StoreServer] = None
        self._connect_timeout = connect_timeout
        if is_server:
            self._server = _StoreServer((host, port))
            self.port = self._server.server_address[1]
            self._server_thread = threading.Thread(target=self._server.serve_forever, daemon=True)
            self._server_thread.start()
        else:
            self.port = port
        self.host = host
        self._sock: Optional[socket.socket] = None
        self._sock_lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            deadline = time.monotonic() + self._connect_timeout
            while True:
                # Per-attempt timeout bounded by the remaining deadline, so
                # an unreachable host cannot hold the dial for minutes.
                remaining = deadline - time.monotonic()
                try:
                    sock = socket.create_connection(
                        (self.host, self.port), timeout=max(0.05, min(5.0, remaining))
                    )
                    sock.settimeout(None)
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    self._sock = sock
                    break
                except socket.gaierror:
                    # A name that does not resolve is a misconfiguration,
                    # not a leader that has not bound yet: fail fast.
                    raise
                except OSError as e:
                    if time.monotonic() > deadline:
                        raise StoreTimeoutError(
                            f"Timed out connecting to store at {self.host}:{self.port} after "
                            f"{self._connect_timeout:.1f}s (is the rank-0 store server up?)"
                        ) from e
                    time.sleep(0.05)
        return self._sock

    def _request(self, cmd: int, key: str, arg: Any = None) -> Any:
        t0 = time.monotonic()
        with self._sock_lock:
            sock = self._connect()
            send_frame(sock, pickle.dumps((cmd, key, arg)))
            reply = pickle.loads(recv_frame(sock))
        _observe_store_requests(_CMD_OP_NAMES.get(cmd, "other"), time.monotonic() - t0)
        return reply

    def set(self, key: str, value: bytes) -> None:
        self._request(_CMD_SET, key, value)

    def try_get(self, key: str) -> Optional[bytes]:
        return self._request(_CMD_TRY_GET, key)

    def add(self, key: str, amount: int) -> int:
        return self._request(_CMD_ADD, key, amount)

    def delete(self, key: str) -> None:
        self._request(_CMD_DELETE, key)

    def multi_set(self, items: Dict[str, bytes]) -> None:
        self._request(_CMD_MULTI_SET, "", dict(items))

    def multi_get(self, keys: Sequence[str]) -> Dict[str, Optional[bytes]]:
        return self._request(_CMD_MULTI_GET, "", list(keys))

    def multi_delete(self, keys: Iterable[str]) -> None:
        self._request(_CMD_MULTI_DELETE, "", list(keys))

    def close(self) -> None:
        with self._sock_lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class InProcessStore(Store):
    """Thread-shared store for single-process, multi-thread tests."""

    def __init__(self) -> None:
        self._kv: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: bytes) -> None:
        with self._lock:
            self._kv[key] = value

    def try_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._kv.get(key)

    def add(self, key: str, amount: int) -> int:
        with self._lock:
            new = int(self._kv.get(key, b"0")) + amount
            self._kv[key] = str(new).encode()
            return new

    def delete(self, key: str) -> None:
        with self._lock:
            self._kv.pop(key, None)

    def multi_set(self, items: Dict[str, bytes]) -> None:
        with self._lock:
            self._kv.update(items)

    def multi_get(self, keys: Sequence[str]) -> Dict[str, Optional[bytes]]:
        with self._lock:
            return {k: self._kv.get(k) for k in keys}

    def multi_delete(self, keys: Iterable[str]) -> None:
        with self._lock:
            for k in keys:
                self._kv.pop(k, None)


# ---------------------------------------------------------------------------
# Sharded store
# ---------------------------------------------------------------------------


def shard_for_key(key: str, num_shards: int) -> int:
    """Deterministic key->shard routing (crc32: ``hash()`` is randomized
    per process, and every rank must route a key to the same shard)."""
    return zlib.crc32(key.encode("utf-8", "surrogatepass")) % num_shards


class ShardedStore(Store):
    """N member stores behind deterministic key->shard hashing. A key
    always lands on the same member, so per-key atomicity (``add``, the
    collectives' cleanup counters) holds; batched ops make one round trip
    per touched shard. The base class's collectives and barriers work
    unchanged on top."""

    def __init__(self, stores: Sequence[Store]) -> None:
        if not stores:
            raise ValueError("ShardedStore needs at least one member store")
        self._stores: List[Store] = list(stores)

    def _count_shard(self, shard: int, requests: int = 1) -> None:
        """Per-shard request accounting (``coordination_store_shard_requests_total``)."""
        try:
            telemetry, n, _ = _tele_modules()
            telemetry.metrics().counter_inc(
                n.COORD_STORE_SHARD_REQUESTS_TOTAL, float(requests), shard=str(shard)
            )
        except Exception:  # noqa: BLE001 - telemetry is best-effort
            pass

    def _member(self, key: str) -> Store:
        shard = shard_for_key(key, len(self._stores))
        self._count_shard(shard)
        return self._stores[shard]

    def _group(self, keys: Iterable[str]) -> Dict[int, List[str]]:
        grouped: Dict[int, List[str]] = {}
        for key in keys:
            grouped.setdefault(shard_for_key(key, len(self._stores)), []).append(key)
        for shard in grouped:
            self._count_shard(shard)
        return grouped

    def set(self, key: str, value: bytes) -> None:
        self._member(key).set(key, value)

    def try_get(self, key: str) -> Optional[bytes]:
        return self._member(key).try_get(key)

    def add(self, key: str, amount: int) -> int:
        return self._member(key).add(key, amount)

    def delete(self, key: str) -> None:
        self._member(key).delete(key)

    def multi_set(self, items: Dict[str, bytes]) -> None:
        for shard, keys in self._group(items).items():
            self._stores[shard].multi_set({k: items[k] for k in keys})

    def multi_get(self, keys: Sequence[str]) -> Dict[str, Optional[bytes]]:
        out: Dict[str, Optional[bytes]] = {}
        for shard, shard_keys in self._group(keys).items():
            out.update(self._stores[shard].multi_get(shard_keys))
        return out

    def multi_delete(self, keys: Iterable[str]) -> None:
        for shard, shard_keys in self._group(keys).items():
            self._stores[shard].multi_delete(shard_keys)

    def close(self) -> None:
        for member in self._stores:
            close = getattr(member, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 - best-effort teardown
                    pass


def bootstrap_sharded_store(
    base: Store,
    rank: int,
    world_size: int,
    num_shards: Optional[int] = None,
    prefix: str = "__ts/shard_store",
    timeout: float = _DEFAULT_TIMEOUT_S,
) -> Store:
    """Stand up a :class:`ShardedStore` of TCPStore members over an
    existing store (which only needs ``set`` / ``get``). Rank 0's knob
    reading decides the shard count for the whole job, published through
    ``base``; shard ``i`` is hosted by rank ``i % world_size``.
    ``num_shards <= 1`` returns ``base`` unchanged (the default)."""
    if rank == 0:
        if num_shards is None:
            num_shards = knobs.get_store_shards()
        num_shards = max(1, min(int(num_shards), world_size * 8))
        base.set(f"{prefix}/n", str(num_shards).encode())
    else:
        num_shards = int(base.get(f"{prefix}/n", timeout))
    if num_shards <= 1:
        return base
    members: List[Optional[Store]] = [None] * num_shards
    for i in range(num_shards):
        if i % world_size != rank:
            continue
        host = _local_advertise_host()
        tcp = TCPStore(host="0.0.0.0", port=0, is_server=True)
        tcp.host = host
        base.set(f"{prefix}/{i}", f"{host}:{tcp.port}".encode())
        members[i] = tcp
    for i in range(num_shards):
        if members[i] is not None:
            continue
        host, port = base.get(f"{prefix}/{i}", timeout).decode().rsplit(":", 1)
        members[i] = TCPStore(host=host, port=int(port), is_server=False)
    return ShardedStore([m for m in members if m is not None])


# ---------------------------------------------------------------------------
# torch.distributed bootstrap
# ---------------------------------------------------------------------------


class C10dStore(Store):
    """Adapter over a ``torch.distributed`` c10d store (``TCPStore``,
    ``HashStore``, ``PrefixStore``). Used as the side channel through
    which :func:`torch_process_group` bootstraps this package's own
    :class:`TCPStore` (the c10d store has no non-blocking absent-key
    read that is free of a check-then-get race, so the collectives do
    not run on it directly)."""

    def __init__(self, c10d_store: Any) -> None:
        self._store = c10d_store

    def set(self, key: str, value: bytes) -> None:
        self._store.set(key, value)

    def try_get(self, key: str) -> Optional[bytes]:
        if not self._store.check([key]):
            return None
        return bytes(self._store.get(key))

    def add(self, key: str, amount: int) -> int:
        return int(self._store.add(key, amount))

    def delete(self, key: str) -> None:
        try:
            self._store.delete_key(key)
        except Exception:  # noqa: BLE001 - not every c10d store deletes
            pass


def _c10d_coordinates() -> Tuple[Any, int, int]:
    """``(c10d store, rank, world)``: the initialized default group's
    store, or a rendezvous over torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` / ``MASTER_PORT`` (the ``env://`` method, which also
    joins torchrun's agent store where the launcher provides one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        from torch.distributed import distributed_c10d

        return distributed_c10d._get_default_store(), dist.get_rank(), dist.get_world_size()
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(
            "torch_process_group() needs an initialized torch.distributed default group "
            f"or torchrun's environment; {', '.join(missing)} not set"
        )
    store, rank, world = next(dist.rendezvous("env://"))
    return store, int(rank), int(world)


def torch_process_group() -> ProcessGroup:
    """The process group of a ``torch.distributed`` job: rank and world
    from the default group (or torchrun's environment), coordination over
    this package's :class:`TCPStore`, bootstrapped through the c10d store
    (rank 0 hosts it and publishes its address; the others read it)::

        torch.distributed.init_process_group("nccl")   # or run under torchrun
        pg = torch_process_group()
        Snapshot.take(path, app_state, pg=pg, replicated=["model/**"])

    The result is cached per process: repeated calls return the same
    ProcessGroup (hence the same store), which keeps the ``__pg/*`` op
    sequence shared across call sites and never bootstraps a second
    server under the same address key."""
    global _TORCH_PG
    with _TORCH_PG_LOCK:
        if _TORCH_PG is not None:
            return _TORCH_PG
        c10d_store, rank, world = _c10d_coordinates()
        store: Store = _bootstrap_tcp_store(C10dStore(c10d_store), rank)
        if world > 1:
            store = bootstrap_sharded_store(store, rank, world)
        # The c10d store lives as long as the group: where rank 0 hosts
        # its server (a rendezvous without a default group), dropping it
        # would cut the other ranks' bootstrap reads.
        _TORCH_PG = ProcessGroup(store=store, rank=rank, world_size=world, c10d_store=c10d_store)
        return _TORCH_PG


_TORCH_PG: Optional[ProcessGroup] = None
_TORCH_PG_LOCK = threading.Lock()


def _routable_host() -> str:
    """An address that peers on other hosts can dial for rank 0's
    machine: ``MASTER_ADDR`` when the launcher set it (rank 0 hosts the
    c10d master, and every rank reached it), else this machine's own."""
    addr = os.environ.get("MASTER_ADDR")
    return addr if addr else _local_advertise_host()


def _local_advertise_host() -> str:
    """The name peers dial for this machine (a per-rank server, such as a
    store shard, advertises it). The hostname: peers resolve it when they
    connect. (The JAX package probes the outbound interface instead.)"""
    return socket.gethostname()


def _bootstrap_tcp_store(kv: Store, rank: int, timeout: float = _DEFAULT_TIMEOUT_S) -> TCPStore:
    """Bootstrap a TCPStore using only ``set`` / ``get`` of ``kv``: rank 0
    binds a free port and publishes ``host:port``; the rest fetch it and
    connect."""
    addr_key = "__ts/tcp_store_addr"
    if rank == 0:
        host = _routable_host()
        tcp = TCPStore(host="0.0.0.0", port=0, is_server=True)
        tcp.host = host  # clients, and rank 0's own socket, dial this
        kv.set(addr_key, f"{host}:{tcp.port}".encode())
        return tcp
    host, port = kv.get(addr_key, timeout).decode().rsplit(":", 1)
    return TCPStore(host=host, port=int(port), is_server=False)


# ---------------------------------------------------------------------------
# Endpoint registry (the peer tier's transport bootstrap)
# ---------------------------------------------------------------------------

_ENDPOINT_PREFIX = "__endpoint"


def publish_endpoint(store: Store, service: str, rank: int, host: str, port: int) -> None:
    """Advertise a per-rank network endpoint through the coordination
    store. Endpoint keys are a registry, not collective keys: a re-publish
    overwrites (a replacement rank re-announces itself under its old rank
    id after a preemption) and nothing cleans them up, so a surviving peer
    stays discoverable for the whole run."""
    store.set(f"{_ENDPOINT_PREFIX}/{service}/{rank}", f"{host}:{port}".encode())


def _parse_endpoint(raw: bytes) -> Optional[Tuple[str, int]]:
    try:
        host, port = raw.decode().rsplit(":", 1)
        return host, int(port)
    except (ValueError, UnicodeDecodeError):
        return None


def lookup_endpoint(store: Store, service: str, rank: int) -> Optional[Tuple[str, int]]:
    """The advertised ``(host, port)`` of ``rank``, or None when it never
    published or the store read failed: an unreachable registry reads as
    "no endpoint", never an error in a restore that can proceed without
    peers."""
    try:
        raw = store.try_get(f"{_ENDPOINT_PREFIX}/{service}/{rank}")
    except Exception:  # noqa: BLE001 - "no endpoint", never raise
        return None
    return None if raw is None else _parse_endpoint(raw)


def lookup_endpoints(store: Store, service: str, ranks: Iterable[int]) -> Dict[int, Tuple[str, int]]:
    """Every advertised ``(host, port)`` of ``ranks`` in one ``multi_get``
    round trip. Ranks that never published, or whose entry does not
    parse, are absent; a failed store read returns ``{}``. The resolve's
    wall time feeds ``coordination_endpoint_seconds_total``."""
    rank_list = list(ranks)
    keys = [f"{_ENDPOINT_PREFIX}/{service}/{r}" for r in rank_list]
    t0 = time.monotonic()
    try:
        got = store.multi_get(keys)
    except Exception:  # noqa: BLE001 - "no endpoint", never raise
        return {}
    finally:
        try:
            telemetry, n, _ = _tele_modules()
            telemetry.metrics().counter_inc(
                n.COORD_ENDPOINT_SECONDS_TOTAL, time.monotonic() - t0, service=service
            )
        except Exception:  # noqa: BLE001 - telemetry is best-effort
            pass
    out: Dict[int, Tuple[str, int]] = {}
    for rank, key in zip(rank_list, keys):
        raw = got.get(key)
        parsed = None if raw is None else _parse_endpoint(raw)
        if parsed is not None:
            out[rank] = parsed
    return out


# ---------------------------------------------------------------------------
# Barriers
# ---------------------------------------------------------------------------


class StoreBarrier:
    """Two-phase (arrive / depart) barrier machinery with error
    propagation. Subclasses implement ``_phase`` (the rendezvous
    topology) and ``_cleanup``. The contract is the same for every
    topology: usable off the main thread; ``report_error`` poisons every
    peer's pending and future wait with :class:`BarrierError`; ``depart``
    before ``arrive`` raises. Every phase is traced (``barrier:arrive`` /
    ``barrier:depart`` spans) and its wall time feeds
    ``coordination_barrier_wait_seconds_total``."""

    _IMPL = "base"

    def __init__(self, prefix: str, store: Store, rank: int, world_size: int) -> None:
        self.prefix = prefix
        self.store = store
        self.rank = rank
        self.world_size = world_size
        self._arrived = False

    def _key(self, name: str) -> str:
        return f"{self.prefix}/{name}"

    def _check_error(self, reads: Optional[_TransientReads] = None) -> None:
        if reads is None:
            reads = _TransientReads()
        err = reads.read(lambda: self.store.try_get(self._key("error")))
        if err is not None:
            self._raise_peer_error(err)

    def _raise_peer_error(self, payload: bytes) -> None:
        exc = pickle.loads(payload)
        raise BarrierError(
            f"Rank {self.rank}: a peer reported an error into barrier {self.prefix!r}"
        ) from exc

    def _wait_for(self, key: str, timeout: float) -> None:
        """Wait for ``key`` with backoff; the error key rides the same
        batched read."""
        deadline = time.monotonic() + timeout
        reads = _TransientReads()
        pacer = _PollPacer(cap=scaled_poll_cap(self.world_size))
        while True:
            got = reads.read(lambda: self.store.multi_get([self._key("error"), key]))
            if got is not None:
                err = got.get(self._key("error"))
                if err is not None:
                    self._raise_peer_error(err)
                if got.get(key) is not None:
                    return
            if time.monotonic() > deadline:
                raise StoreTimeoutError(
                    f"Rank {self.rank} timed out in barrier {self.prefix!r} waiting for {key!r}"
                )
            pacer.sleep(deadline)

    def _wait_count(self, key: str, target: int, timeout: float) -> None:
        """Poll one counter key until it reaches ``target``: O(1) store
        requests per poll whatever the world size."""
        if target <= 0:
            self._check_error()
            return
        deadline = time.monotonic() + timeout
        reads = _TransientReads()
        pacer = _PollPacer(cap=scaled_poll_cap(self.world_size))
        while True:
            got = reads.read(lambda: self.store.multi_get([self._key("error"), key]))
            if got is not None:
                err = got.get(self._key("error"))
                if err is not None:
                    self._raise_peer_error(err)
                val = got.get(key)
                if val is not None and int(val) >= target:
                    return
            if time.monotonic() > deadline:
                raise StoreTimeoutError(
                    f"Rank {self.rank} timed out in barrier {self.prefix!r} waiting for "
                    f"{key!r} to reach {target}"
                )
            pacer.sleep(deadline)

    def _phase(self, phase: str, timeout: float) -> None:
        raise NotImplementedError

    def _cleanup(self, timeout: float) -> None:
        raise NotImplementedError

    def _observed_phase(self, phase: str, timeout: float) -> None:
        t0 = time.monotonic()
        token = None
        tele = n = trace = None
        try:
            tele, n, trace = _tele_modules()
            token = trace.get_recorder().begin(
                n.SPAN_BARRIER_ARRIVE if phase == "arrive" else n.SPAN_BARRIER_DEPART,
                prefix=self.prefix, rank=self.rank, world=self.world_size, impl=self._IMPL,
            )
        except Exception:  # noqa: BLE001 - telemetry is best-effort
            token = None
        try:
            self._phase(phase, timeout)
        finally:
            try:
                if token is not None:
                    trace.get_recorder().end(token)
                if tele is not None:
                    tele.metrics().counter_inc(
                        n.COORD_BARRIER_WAIT_SECONDS_TOTAL, time.monotonic() - t0,
                        phase=phase, impl=self._IMPL,
                    )
            except Exception:  # noqa: BLE001 - telemetry is best-effort
                pass

    def arrive(self, timeout: float = _DEFAULT_TIMEOUT_S) -> None:
        self._observed_phase("arrive", timeout)
        self._arrived = True

    def depart(self, timeout: float = _DEFAULT_TIMEOUT_S) -> None:
        if not self._arrived:
            raise RuntimeError("depart() called before arrive()")
        self._observed_phase("depart", timeout)
        self._cleanup(timeout)

    def report_error(self, exc: BaseException) -> None:
        try:
            payload = pickle.dumps(exc)
        except Exception:
            payload = pickle.dumps(RuntimeError(repr(exc)))
        self.store.set(self._key("error"), payload)


class LinearBarrier(StoreBarrier):
    """Leader-centric two-phase barrier: followers deposit into one
    counter, the leader observes all deposits and releases one ``go``
    key; depart mirrors it. Behind the ``TORCHSNAPSHOT_TPU_TREE_BARRIER=0``
    kill switch (see :func:`make_barrier`)."""

    _IMPL = "linear"

    def _phase(self, phase: str, timeout: float) -> None:
        if self.rank == 0:
            self._wait_count(self._key(f"{phase}/count"), self.world_size - 1, timeout)
            self.store.set(self._key(f"{phase}/go"), b"1")
        else:
            self._check_error()
            self.store.add(self._key(f"{phase}/count"), 1)
            self._wait_for(self._key(f"{phase}/go"), timeout)

    def _cleanup(self, timeout: float) -> None:
        """Best-effort key removal after a successful depart: followers
        ack that they are past the release before the leader deletes."""
        try:
            if self.rank != 0:
                self.store.add(self._key("done/count"), 1)
                return
            self._wait_count(self._key("done/count"), self.world_size - 1, timeout)
            self.store.multi_delete(
                [
                    self._key(f"{phase}/{part}")
                    for phase in ("arrive", "depart", "done")
                    for part in ("count", "go")
                ]
                + [self._key("error")]
            )
        except Exception:  # pragma: no cover - cleanup must never fail a commit
            pass


class TreeBarrier(StoreBarrier):
    """Tree-structured two-phase barrier: O(log_k world) critical path and
    no key with more than ``fanout`` writers or readers. The children of
    rank ``r`` are ``r*k+1 .. r*k+k``; per phase a rank waits for its
    counter to reach its child count, increments its parent's, waits for
    its release key, then releases its children in one ``multi_set``.
    Same contract as :class:`LinearBarrier`."""

    _IMPL = "tree"

    def __init__(
        self,
        prefix: str,
        store: Store,
        rank: int,
        world_size: int,
        fanout: Optional[int] = None,
    ) -> None:
        super().__init__(prefix, store, rank, world_size)
        if fanout is None:
            fanout = knobs.get_barrier_fanout()
        self.fanout = max(2, int(fanout))

    def _children(self) -> List[int]:
        base = self.rank * self.fanout
        return [c for c in range(base + 1, base + self.fanout + 1) if c < self.world_size]

    def _phase(self, phase: str, timeout: float) -> None:
        children = self._children()
        if children:
            self._wait_count(self._key(f"{phase}/c/{self.rank}"), len(children), timeout)
        if self.rank != 0:
            self._check_error()
            parent = (self.rank - 1) // self.fanout
            self.store.add(self._key(f"{phase}/c/{parent}"), 1)
            self._wait_for(self._key(f"{phase}/go/{self.rank}"), timeout)
        if children:
            self.store.multi_set({self._key(f"{phase}/go/{c}"): b"1" for c in children})

    def _cleanup(self, timeout: float) -> None:
        """Each rank deletes its own keys: after its depart nobody touches
        them again (children increment before waiting for release)."""
        try:
            keys = [
                self._key(f"{phase}/{part}/{self.rank}")
                for phase in ("arrive", "depart")
                for part in ("c", "go")
            ]
            if self.rank == 0:
                keys.append(self._key("error"))
            self.store.multi_delete(keys)
        except Exception:  # pragma: no cover - cleanup must never fail a commit
            pass


def make_barrier(prefix: str, store: Store, rank: int, world_size: int) -> StoreBarrier:
    """The barrier of every coordination phase: :class:`TreeBarrier`
    (fanout from ``TORCHSNAPSHOT_TPU_BARRIER_FANOUT``) unless the
    ``TORCHSNAPSHOT_TPU_TREE_BARRIER=0`` kill switch picks
    :class:`LinearBarrier`. Set both knobs uniformly across ranks."""
    if knobs.is_tree_barrier_enabled():
        return TreeBarrier(prefix, store, rank, world_size)
    return LinearBarrier(prefix, store, rank, world_size)
