"""The chaos engine: evaluates a fault plan against injection events.

Counterpart of ``torchsnapshot_tpu/chaos/engine.py``.
One engine instance holds one :class:`~torchsnapshot_tpu_torch.chaos.plan.
FaultPlan` and a per-spec trigger state (match counter, seeded RNG,
fires-so-far). Layers hand it events — ``engine.on_event(point, key)``
— and get back ``None`` (proceed) or the :class:`FaultSpec` that fired;
the wrappers below translate a fired spec into the concrete damage
(raise / sleep / flip a byte / tear / drop / simulated crash).

Determinism: per-spec RNGs are seeded ``plan.seed + spec index`` and
advance only on matching events, so the same plan over the same event
stream fires identically — the property the replay workflow (print one
JSON line, re-run) rests on. ``engine.fired`` records every trigger as
``(point, key, mode)`` for tests that pin schedule identity.

Three wrapping surfaces:

- :func:`wrap_plugin` / :func:`chaotic_plugin_type` — any
  :class:`StoragePlugin` (instance wrapper / subclass factory for
  ``patch_storage_plugin``-style class injection).
- :class:`ChaosStore` — any coordination ``Store``.
- :func:`install_wire_chaos` — the socket framing of the TCP store and
  the peer tier (``dist_store.send_frame``/``recv_frame``): a sent frame
  reaches the hook with its trace header in front, a received one before
  the header is decoded, so damage lands where wire damage would.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Callable, List, Optional, Tuple

from ..io_types import (
    BufferList,
    ReadIO,
    StoragePlugin,
    WriteIO,
    as_bytes_view,
    payload_nbytes,
)
from .crashpoints import SimulatedCrash
from .plan import FaultPlan, FaultSpec


class _SpecState:
    __slots__ = ("spec", "rng", "seen", "fired")

    def __init__(self, spec: FaultSpec, seed: int) -> None:
        import random

        self.spec = spec
        self.rng = random.Random(seed)
        self.seen = 0
        self.fired = 0


class ChaosEngine:
    """Thread-safe trigger evaluation over one fault plan."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self._lock = threading.Lock()
        self._states = [
            _SpecState(spec, plan.seed + i)
            for i, spec in enumerate(plan.faults)
        ]
        # Every trigger, in order: (point, key, mode) — the replay pin.
        self.fired: List[Tuple[str, str, str]] = []

    def on_event(self, point: str, key: str = "") -> Optional[FaultSpec]:
        """Record one injection event; the first spec that triggers on
        it wins (at most one fault per event)."""
        with self._lock:
            for state in self._states:
                spec = state.spec
                if spec.point != point or not spec.matches(key):
                    continue
                state.seen += 1
                if state.seen <= spec.after:
                    continue
                if spec.times is not None and state.fired >= spec.times:
                    continue
                if spec.prob < 1.0 and state.rng.random() >= spec.prob:
                    continue
                state.fired += 1
                self.fired.append((point, key, spec.mode))
                return spec
            return None

    def raise_for(self, spec: FaultSpec, key: str) -> None:
        if spec.mode == "crash":
            raise SimulatedCrash(f"chaos: simulated crash at {key!r}")
        raise OSError(f"{spec.exc_msg} ({spec.point} {key!r})")


def corrupt_bytes(buf: bytes | bytearray | memoryview) -> bytes:
    """Size-preserving damage: flip one bit of the middle byte (an
    empty payload is returned unchanged — nothing to damage)."""
    data = bytearray(as_bytes_view(buf))
    if data:
        data[len(data) // 2] ^= 0x01
    return bytes(data)


# ---------------------------------------------------------------------------
# Storage plugin surface
# ---------------------------------------------------------------------------


async def _inject_write(
    engine: ChaosEngine,
    write_io: WriteIO,
    inner_write: Callable[[WriteIO], Any],
) -> None:
    spec = engine.on_event("storage-write", write_io.path)
    if spec is None:
        await inner_write(write_io)
        return
    if spec.mode == "delay":
        await asyncio.sleep(spec.delay_s)
        await inner_write(write_io)
        return
    if spec.mode == "drop":
        return  # a lost write: success reported, nothing persisted
    if spec.mode == "corrupt":
        buf = write_io.buf
        if isinstance(buf, BufferList):
            buf = buf.consolidate()
        await inner_write(
            WriteIO(path=write_io.path, buf=corrupt_bytes(buf))
        )
        return
    if spec.mode == "torn":
        buf = write_io.buf
        if isinstance(buf, BufferList):
            buf = buf.consolidate()
        mv = as_bytes_view(buf)
        await inner_write(
            WriteIO(path=write_io.path, buf=bytes(mv[: mv.nbytes // 2]))
        )
        raise OSError(f"{spec.exc_msg} (torn write of {write_io.path!r})")
    if spec.delay_s:  # a slow failure (timeout-shaped), not a fast one
        await asyncio.sleep(spec.delay_s)
    engine.raise_for(spec, write_io.path)


async def _inject_read(
    engine: ChaosEngine,
    read_io: ReadIO,
    inner_read: Callable[[ReadIO], Any],
) -> None:
    spec = engine.on_event("storage-read", read_io.path)
    if spec is None:
        await inner_read(read_io)
        return
    if spec.mode == "delay":
        await asyncio.sleep(spec.delay_s)
        await inner_read(read_io)
        return
    if spec.mode == "corrupt":
        # Read the real bytes, then damage what the caller sees. The
        # read must not land in a caller-owned direct destination
        # un-damaged, so the direct path is disabled for this request.
        shadow = ReadIO(path=read_io.path, byte_range=read_io.byte_range)
        await inner_read(shadow)
        damaged = corrupt_bytes(
            shadow.buf if shadow.buf is not None else b""
        )
        if read_io.dest is not None and len(read_io.dest) == len(damaged):
            read_io.dest[:] = damaged
            read_io.buf = read_io.dest
        else:
            read_io.buf = memoryview(damaged)
        read_io.served_by = shadow.served_by
        return
    if spec.delay_s:  # a slow failure (timeout-shaped), not a fast one
        await asyncio.sleep(spec.delay_s)
    engine.raise_for(spec, read_io.path)


class ChaosStoragePlugin(StoragePlugin):
    """Instance wrapper: every op of ``inner`` rides the engine.

    The fused ``*_with_checksum`` hooks decline (having done nothing):
    the scheduler then computes/verifies digests over the *original*
    bytes and calls the plain ops — which is exactly what makes
    ``corrupt`` injections land as restore-time ``ChecksumError``
    rather than silently poisoning the recorded tables. For the same
    reason the wrapper declares no multibuffer support (the scheduler
    consolidates first; the engine sees one buffer per blob)."""

    supports_multibuffer = False

    def __init__(self, inner: StoragePlugin, engine: ChaosEngine) -> None:
        self.inner = inner
        self.engine = engine

    async def write(self, write_io: WriteIO) -> None:
        await _inject_write(self.engine, write_io, self.inner.write)

    async def read(self, read_io: ReadIO) -> None:
        await _inject_read(self.engine, read_io, self.inner.read)

    async def read_degraded(self, read_io: ReadIO) -> bool:
        # The healing ladder re-reads through the inner plugin directly:
        # the adversary damaged a tier copy; the ladder's whole point is
        # reaching the OTHER tier's bytes.
        return await self.inner.read_degraded(read_io)

    async def delete(self, path: str) -> None:
        spec = self.engine.on_event("storage-delete", path)
        if spec is not None:
            if spec.mode == "delay":
                await asyncio.sleep(spec.delay_s)
            elif spec.mode == "drop":
                return
            else:
                self.engine.raise_for(spec, path)
        await self.inner.delete(path)

    async def close(self) -> None:
        await self.inner.close()


def wrap_plugin(inner: StoragePlugin, engine: ChaosEngine) -> StoragePlugin:
    return ChaosStoragePlugin(inner, engine)


def chaotic_plugin_type(base_cls: type, engine: ChaosEngine) -> type:
    """Subclass factory for class-injection seams (``test_utils.
    patch_storage_plugin`` constructs plugins from a CLASS): a
    ``base_cls`` whose plain ops ride ``engine`` and whose fused
    ``*_with_checksum`` hooks decline, with the same rationale as
    :class:`ChaosStoragePlugin`."""

    class _Chaotic(base_cls):  # type: ignore[misc,valid-type]
        supports_multibuffer = False

        async def write(self, write_io: WriteIO) -> None:
            await _inject_write(engine, write_io, super().write)

        async def write_with_checksum(self, write_io: WriteIO):
            return None  # decline: route through write() + engine

        async def read(self, read_io: ReadIO) -> None:
            await _inject_read(engine, read_io, super().read)

        async def read_with_checksum(self, read_io: ReadIO):
            return None  # decline: route through read() + engine

        async def delete(self, path: str) -> None:
            spec = engine.on_event("storage-delete", path)
            if spec is not None:
                if spec.mode == "delay":
                    await asyncio.sleep(spec.delay_s)
                elif spec.mode == "drop":
                    return
                else:
                    engine.raise_for(spec, path)
            await super().delete(path)

    _Chaotic.__name__ = f"Chaotic{base_cls.__name__}"
    _Chaotic.__qualname__ = _Chaotic.__name__
    return _Chaotic


# ---------------------------------------------------------------------------
# Coordination-store surface
# ---------------------------------------------------------------------------


def _store_base() -> type:
    from ..dist_store import Store

    return Store


class ChaosStore(_store_base()):
    """Delegating ``Store`` wrapper riding the engine on the four
    primitive ops. Subclassing the ABC (the ``ByteCountingStore``
    shape) means every inherited collective — gather, broadcast,
    barriers, the per-key ``multi_*`` fallbacks — runs through the
    wrapped primitives, so one wrapper chaoses all coordination
    traffic."""

    def __init__(self, inner: Any, engine: ChaosEngine) -> None:
        self.inner = inner
        self.engine = engine

    def _gate(self, point: str, key: str) -> Optional[FaultSpec]:
        import time

        spec = self.engine.on_event(point, key)
        if spec is None:
            return None
        if spec.mode == "delay":
            time.sleep(spec.delay_s)
            return None
        if spec.mode == "drop":
            return spec
        if spec.mode == "crash":
            raise SimulatedCrash(f"chaos: simulated crash at {key!r}")
        raise ConnectionError(f"{spec.exc_msg} ({point} {key!r})")

    def set(self, key: str, value: bytes) -> None:
        if self._gate("store-set", key) is not None:
            return  # dropped
        self.inner.set(key, value)

    def try_get(self, key: str):
        if self._gate("store-get", key) is not None:
            return None  # dropped: reads as absent
        return self.inner.try_get(key)

    def add(self, key: str, amount: int) -> int:
        if self._gate("store-add", key) is not None:
            # A "dropped" add has no honest success value: the request
            # (or its response) was lost, and the client cannot know
            # the counter — surface it as the connection error a lost
            # round trip produces.
            raise ConnectionError(
                f"chaos: dropped store-add round trip ({key!r})"
            )
        return self.inner.add(key, amount)

    def delete(self, key: str) -> None:
        if self._gate("store-delete", key) is not None:
            return
        self.inner.delete(key)

    def __getattr__(self, name: str) -> Any:
        return getattr(self.inner, name)


# ---------------------------------------------------------------------------
# Wire surface (send_frame/recv_frame)
# ---------------------------------------------------------------------------


def install_wire_chaos(engine: ChaosEngine) -> None:
    """Route every length-prefixed frame of the TCP store through
    ``engine``: ``wire-send``/``wire-recv`` events keyed by the
    frame length. ``fail`` raises ``ConnectionError``, ``delay``
    sleeps, ``corrupt`` flips a payload byte (the receiver's parse /
    digest check catches it), ``drop`` on ``wire-send`` swallows the
    frame so the receiver's timeout/backoff path is what gets
    exercised. Process-local; pair with
    :func:`uninstall_wire_chaos` in a finally block."""
    from .. import dist_store

    dist_store._WIRE_CHAOS = _WireHook(engine)


def uninstall_wire_chaos() -> None:
    from .. import dist_store

    dist_store._WIRE_CHAOS = None


class _WireHook:
    __slots__ = ("engine",)

    def __init__(self, engine: ChaosEngine) -> None:
        self.engine = engine

    def __call__(self, point: str, payload: bytes) -> Optional[bytes]:
        import time

        spec = self.engine.on_event(point, str(len(payload)))
        if spec is None:
            return payload
        if spec.mode == "delay":
            time.sleep(spec.delay_s)
            return payload
        if spec.mode == "corrupt":
            return corrupt_bytes(payload)
        if spec.mode == "crash":
            raise SimulatedCrash("chaos: simulated crash on the wire")
        if spec.mode == "drop":
            if point == "wire-send":
                return None  # frame vanishes; the receiver waits it out
            # A received-then-dropped frame reads as a dead stream on
            # this side — there is no way to "unreceive" bytes.
            raise ConnectionError(f"{spec.exc_msg} (dropped frame)")
        raise ConnectionError(f"{spec.exc_msg} ({point})")
