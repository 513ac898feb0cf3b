"""Wire observatory: cross-process RPC tracing, per-endpoint wire
metrics, and the fleet metrics plane.

Counterpart of ``torchsnapshot_tpu/telemetry/wire.py``, byte for byte in
what crosses a process boundary: the frame header, the ``__obs/`` fleet
entries and the rendered fleet table are the JAX module's, so either
package's servers read the other's propagated context and either CLI
renders the other's fleet. Three instruments over the socket seams
(``dist_store.send_frame`` / ``recv_frame`` and everything riding them:
the TCP coordination store, the peer tier, the CDN fleet):

**Context propagation.**  A sender inside a :func:`propagate` block
prefixes each framed payload with a fixed-length header carrying a
trace id, the sender's span id, and a declared RPC op id
(``names.RPC_*``).  The receiver strips the header, exposes it through
:func:`last_received_context`, and the handler opens its span with
``trace_id`` / ``parent_span_id`` args, so one CDN pull or peer push
appears as one causally linked trace across processes once ``python -m
torchsnapshot_tpu_torch.telemetry trace`` merges the timelines.  The
header is guarded by magic + crc32: a corrupted, torn or version-skewed
header (``install_wire_chaos`` flips bytes on exactly this seam)
degrades to a context-free frame with the body intact, never a
protocol error.

**Per-endpoint wire metrics.**  Always-on registry series recorded at
the framing layer and the dial / request sites: frames and bytes by
``endpoint`` (store | peer) and ``dir`` (send | recv), dial latency
(histogram plus a bounded recent-sample ring that feeds the
``wire-dial-stalled`` doctor rule: an overflowing listen backlog shows
up as dial latencies quantized at whole seconds), in-flight requests,
connection-pool checkout outcomes, accept-pressure depth, and per-RPC
latency by declared op id.

**Fleet metrics plane.**  Each publisher (a storm rank, a CDN publisher
or subscriber) writes one bounded, crc-guarded JSON snapshot under
``__obs/<role>/<id>`` on the coordination store via ``multi_set``,
paced by a world-scaled interval; readers skip torn or stale entries
and publishers reap their key via ``multi_delete`` on a clean close.
``python -m torchsnapshot_tpu_torch.telemetry fleet <host:port | root>``
renders the live per-publisher table and runs the fleet-scope doctor
rules.  Publishing is opt-in: ``TORCHSNAPSHOT_TPU_FLEET_OBS=1``.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

from . import names

__all__ = [
    "HEADER_LEN",
    "OBS_PREFIX",
    "FleetReporter",
    "WireContext",
    "collect_fleet",
    "current_context",
    "decode_fleet_entry",
    "decode_frame",
    "encode_fleet_entry",
    "encode_frame",
    "encode_header",
    "fleet_main",
    "fleet_snapshot",
    "last_received_context",
    "local_wire_summary",
    "new_id",
    "open_fleet_store",
    "observe_accept_depth",
    "observe_dial",
    "observe_frame",
    "observe_pool_checkout",
    "observe_rpc",
    "propagate",
    "quantized_dial_fraction",
    "read_fleet_endpoint",
    "recent_dial_seconds",
    "render_fleet_table",
    "rpc_inflight",
    "set_received_context",
    "write_fleet_endpoint",
]


def _metrics():
    # Lazy: wire.py is imported during the telemetry package's init,
    # before the package-level registry exists.
    from . import metrics

    return metrics()


# ---------------------------------------------------------------------------
# context propagation: the compact frame header
# ---------------------------------------------------------------------------

# Fixed-length header so a receiver can ALWAYS strip it once the magic
# matches, even when chaos flipped a byte inside it: magic(4) +
# version(1) + reserved(1) + op(24, NUL-padded kebab-case RPC id from
# names.RPC_*) + trace_id(8) + span_id(8) + crc32 of the preceding
# bytes(4).  A failed crc / unknown version degrades to a context-free
# frame with the body intact — never a protocol error (the wire-chaos
# suite pins this).  A frame that starts with the magic but is shorter
# than the header is torn: the context is dropped and the raw payload
# passed through untouched.
_MAGIC = b"TSWC"
_WIRE_VERSION = 1
_OP_FIELD_LEN = 24
_HEADER = struct.Struct("<4sBB24s8s8sI")
HEADER_LEN = _HEADER.size


@dataclass(frozen=True)
class WireContext:
    """One hop's tracing identity, carried inside the frame header."""

    trace_id: str  # 16 hex chars shared by every hop of one logical op
    span_id: str  # 16 hex chars: the sender's span = receiver's parent
    op: str  # declared RPC id (names.RPC_*)


def new_id() -> str:
    """A fresh 64-bit trace/span id as 16 hex chars."""
    return os.urandom(8).hex()


def encode_header(ctx: WireContext) -> bytes:
    """The ``HEADER_LEN``-byte context header for ``ctx``: what
    :func:`encode_frame` puts in front of a body (the framing layer sends
    the two without joining them first)."""
    op = ctx.op.encode("ascii", "replace")[:_OP_FIELD_LEN]
    try:
        tid = bytes.fromhex(ctx.trace_id)[:8].rjust(8, b"\x00")
        sid = bytes.fromhex(ctx.span_id)[:8].rjust(8, b"\x00")
    except ValueError:
        tid = sid = b"\x00" * 8
    head = _HEADER.pack(_MAGIC, _WIRE_VERSION, 0, op, tid, sid, 0)[:-4]
    return head + struct.pack("<I", zlib.crc32(head))


def encode_frame(ctx: WireContext, body: bytes) -> bytes:
    """Prefix ``body`` with the context header for ``ctx``."""
    return encode_header(ctx) + body


def _count_degraded(reason: str) -> None:
    try:
        _metrics().counter_inc(
            names.WIRE_CONTEXT_DEGRADED_TOTAL, reason=reason
        )
    except Exception:  # noqa: BLE001 - accounting never breaks the wire
        pass


def decode_frame(payload: bytes) -> Tuple[Optional[WireContext], bytes]:
    """Split a received payload into ``(context, body)``.

    Context-free payloads (no magic) pass through untouched.  A
    header whose crc or version fails is stripped but yields no
    context; a torn header (magic present, frame shorter than the
    header) passes the raw payload through.  Every degraded shape
    increments ``wire_context_degraded_total`` with a ``reason``.
    """
    if not payload.startswith(_MAGIC):
        return None, payload
    if len(payload) < HEADER_LEN:
        _count_degraded("torn")
        return None, payload
    _magic, version, _flags, op_raw, tid, sid, crc = _HEADER.unpack_from(
        payload
    )
    if zlib.crc32(payload[: HEADER_LEN - 4]) != crc:
        _count_degraded("crc")
        return None, payload[HEADER_LEN:]
    if version != _WIRE_VERSION:
        _count_degraded("version")
        return None, payload[HEADER_LEN:]
    op = op_raw.rstrip(b"\x00").decode("ascii", "replace")
    return WireContext(tid.hex(), sid.hex(), op), payload[HEADER_LEN:]


_TLS = threading.local()


def current_context() -> Optional[WireContext]:
    """The active outbound context for this thread, if any."""
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def propagate(op: str, trace_id: Optional[str] = None) -> Iterator[WireContext]:
    """Open an outbound wire context: frames sent by this thread while
    the block is active carry ``op`` plus a trace/span id pair.  Nested
    blocks inherit the enclosing trace id, so a composite op (a fan-out
    exchange, a CDN sync) links every frame it causes under one trace.
    """
    parent = current_context()
    ctx = WireContext(
        trace_id=trace_id
        or (parent.trace_id if parent is not None else new_id()),
        span_id=new_id(),
        op=op,
    )
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = parent


def set_received_context(ctx: Optional[WireContext]) -> None:
    """Record the context decoded from the most recent inbound frame on
    this thread (``recv_frame`` calls this; handlers read it back)."""
    _TLS.received = ctx


def last_received_context() -> Optional[WireContext]:
    """The context carried by this thread's most recent inbound frame,
    or None when it was context-free (or degraded by chaos)."""
    return getattr(_TLS, "received", None)


# ---------------------------------------------------------------------------
# per-endpoint wire metrics
# ---------------------------------------------------------------------------

# Bounded ring of recent successful dial latencies per endpoint: the
# raw samples behind the wire-dial-stalled rule and the fleet
# snapshot's dial percentiles (a histogram alone cannot show the
# whole-second quantization signature).
_RECENT_DIALS_KEEP = 64
_DIAL_LOCK = threading.Lock()
_RECENT_DIALS: Dict[str, Deque[float]] = {}

_INFLIGHT_LOCK = threading.Lock()
_INFLIGHT: Dict[str, int] = {}

# Accept-pressure depth is a count, not seconds.
_DEPTH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


def observe_frame(endpoint: str, direction: str, nbytes: int) -> None:
    """One frame on the wire (direction: "send" | "recv"); ``nbytes``
    includes the 4-byte length prefix and any context header."""
    reg = _metrics()
    reg.counter_inc(names.WIRE_FRAMES_TOTAL, endpoint=endpoint, dir=direction)
    reg.counter_inc(
        names.WIRE_BYTES_TOTAL, nbytes, endpoint=endpoint, dir=direction
    )


def observe_dial(endpoint: str, seconds: float, ok: bool = True) -> None:
    """One connection attempt; only successful dials feed the latency
    histogram and the recent-sample ring (the backlog-stall signature
    lives in dials that eventually SUCCEED after SYN retransmits)."""
    reg = _metrics()
    reg.counter_inc(
        names.WIRE_DIALS_TOTAL,
        endpoint=endpoint,
        outcome="ok" if ok else "error",
    )
    if not ok:
        return
    reg.counter_inc(names.WIRE_DIAL_SECONDS_TOTAL, seconds, endpoint=endpoint)
    reg.histogram_observe(names.WIRE_DIAL_SECONDS, seconds, endpoint=endpoint)
    with _DIAL_LOCK:
        ring = _RECENT_DIALS.get(endpoint)
        if ring is None:
            ring = _RECENT_DIALS[endpoint] = deque(maxlen=_RECENT_DIALS_KEEP)
        ring.append(seconds)


def recent_dial_seconds(endpoint: Optional[str] = None) -> List[float]:
    """Recent successful dial latencies (newest last), one endpoint or
    all of them."""
    with _DIAL_LOCK:
        if endpoint is not None:
            return list(_RECENT_DIALS.get(endpoint, ()))
        return [s for ring in _RECENT_DIALS.values() for s in ring]


def reset_recent_dials() -> None:
    """Drop the dial-sample rings (tests simulating a fresh process)."""
    with _DIAL_LOCK:
        _RECENT_DIALS.clear()


def observe_rpc(endpoint: str, op: str, seconds: float) -> None:
    """One completed request/reply round trip for a declared RPC op."""
    reg = _metrics()
    reg.counter_inc(names.WIRE_RPCS_TOTAL, endpoint=endpoint, op=op)
    reg.counter_inc(
        names.WIRE_RPC_SECONDS_TOTAL, seconds, endpoint=endpoint, op=op
    )
    reg.histogram_observe(
        names.WIRE_RPC_SECONDS, seconds, endpoint=endpoint, op=op
    )


def observe_pool_checkout(endpoint: str, outcome: str) -> None:
    """One connection-pool checkout (outcome: "reused" | "new" |
    "dead" — dead meaning the pooled socket had to be discarded)."""
    _metrics().counter_inc(
        names.WIRE_POOL_CHECKOUTS_TOTAL, endpoint=endpoint, outcome=outcome
    )


def observe_accept_depth(endpoint: str, depth: int) -> None:
    """Server-side accept pressure: the number of connections a server
    is concurrently handling when a new one arrives (a userspace proxy
    for the kernel accept queue, which Python cannot read portably)."""
    _metrics().histogram_observe(
        names.WIRE_ACCEPT_QUEUE_DEPTH,
        float(depth),
        buckets=_DEPTH_BUCKETS,
        endpoint=endpoint,
    )


@contextlib.contextmanager
def rpc_inflight(endpoint: str) -> Iterator[None]:
    """Track one in-flight request against the per-endpoint gauge."""
    reg = _metrics()
    with _INFLIGHT_LOCK:
        _INFLIGHT[endpoint] = _INFLIGHT.get(endpoint, 0) + 1
        reg.gauge_set(
            names.WIRE_INFLIGHT_FRAMES, _INFLIGHT[endpoint], endpoint=endpoint
        )
    try:
        yield
    finally:
        with _INFLIGHT_LOCK:
            _INFLIGHT[endpoint] = max(0, _INFLIGHT.get(endpoint, 1) - 1)
            reg.gauge_set(
                names.WIRE_INFLIGHT_FRAMES,
                _INFLIGHT[endpoint],
                endpoint=endpoint,
            )


# ---------------------------------------------------------------------------
# dial-stall signature (an overflowing listen backlog)
# ---------------------------------------------------------------------------

# A full accept queue makes the kernel drop SYNs; the client retries on
# the retransmission timer, so successful dials cluster at ~1s, ~2s,
# ~3s.  Healthy dials are either fast (< DIAL_STALL_MIN_S) or smeared
# continuously — a large fraction of slow dials sitting within
# DIAL_STALL_TOLERANCE_S of an integer second is the stall signature.
DIAL_STALL_MIN_S = 0.5
DIAL_STALL_TOLERANCE_S = 0.06
DIAL_STALL_MIN_SAMPLES = 3
DIAL_STALL_MIN_FRACTION = 0.6


def quantized_dial_fraction(samples: Sequence[float]) -> Tuple[int, float]:
    """``(slow_sample_count, quantized_fraction)`` over ``samples``:
    how many dials were slow, and what fraction of those sit within
    tolerance of a whole second."""
    slow = [s for s in samples if s >= DIAL_STALL_MIN_S]
    if not slow:
        return 0, 0.0
    quantized = sum(
        1 for s in slow if abs(s - round(s)) <= DIAL_STALL_TOLERANCE_S
    )
    return len(slow), quantized / len(slow)


# ---------------------------------------------------------------------------
# fleet metrics plane
# ---------------------------------------------------------------------------

OBS_PREFIX = "__obs"
FLEET_ENDPOINT_BASENAME = ".fleet-endpoint"
# One snapshot per publisher, and each snapshot bounded: the plane's
# store footprint is O(publishers), never O(time).
SNAPSHOT_MAX_BYTES = 4096
STALE_AFTER_S = 30.0


def _percentile(sorted_samples: Sequence[float], frac: float) -> float:
    if not sorted_samples:
        return 0.0
    return sorted_samples[
        min(len(sorted_samples) - 1, int(len(sorted_samples) * frac))
    ]


def local_wire_summary() -> Dict[str, Any]:
    """This process's wire health, compact enough for a fleet snapshot:
    per-endpoint frame/byte/rpc totals, dial p50/p95 plus the raw
    recent-dial ring (the stall rule needs samples, not quantiles), and
    per-shard coordination-store request counts."""
    from .registry import parse_series_key

    counters = _metrics().counters_snapshot()
    endpoints: Dict[str, Dict[str, float]] = {}
    shards: Dict[str, float] = {}
    degraded = 0.0
    folds = {
        names.WIRE_FRAMES_TOTAL: "frames",
        names.WIRE_BYTES_TOTAL: "bytes",
        names.WIRE_RPCS_TOTAL: "rpcs",
        names.WIRE_RPC_SECONDS_TOTAL: "rpc_s",
        names.WIRE_DIALS_TOTAL: "dials",
    }
    for series, value in counters.items():
        name, labels = parse_series_key(series)
        field = folds.get(name)
        if field is not None:
            ep = endpoints.setdefault(labels.get("endpoint", "?"), {})
            ep[field] = round(ep.get(field, 0.0) + value, 6)
        elif name == names.COORD_STORE_SHARD_REQUESTS_TOTAL:
            shard = labels.get("shard", "?")
            shards[shard] = shards.get(shard, 0.0) + value
        elif name == names.WIRE_CONTEXT_DEGRADED_TOTAL:
            degraded += value
    dials = sorted(recent_dial_seconds())
    summary: Dict[str, Any] = {
        "endpoints": endpoints,
        "dial_p50_s": round(_percentile(dials, 0.5), 4),
        "dial_p95_s": round(_percentile(dials, 0.95), 4),
        # Newest samples last; bounded by the ring size.
        "dials_s": [round(s, 3) for s in recent_dial_seconds()[-32:]],
    }
    if shards:
        summary["store_shards"] = shards
    if degraded:
        summary["context_degraded"] = degraded
    return summary


def fleet_snapshot(
    role: str,
    ident: str,
    seq: int,
    phase: Optional[str] = None,
    written_bytes: Optional[int] = None,
    extra: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    """One publisher's current state as a compact JSON-able dict."""
    snap: Dict[str, Any] = {
        "v": 1,
        "role": role,
        "id": str(ident),
        "seq": int(seq),
        "t": time.time(),
        "wire": local_wire_summary(),
    }
    if phase is not None:
        snap["phase"] = phase
    if written_bytes is not None:
        snap["written_bytes"] = int(written_bytes)
    if extra:
        snap["extra"] = dict(extra)
    return snap


def encode_fleet_entry(snapshot: Mapping[str, Any]) -> bytes:
    """crc-guarded wire form: ``<crc32-hex>:<compact json>``.  A reader
    that observes a torn ``multi_set`` (or a half-written value) sees a
    crc mismatch and skips the entry.  Oversized snapshots shed their
    bulky optional fields rather than growing the plane unboundedly."""
    snap = dict(snapshot)
    body = json.dumps(snap, separators=(",", ":"), sort_keys=True).encode()
    if len(body) > SNAPSHOT_MAX_BYTES:
        for bulky in ("extra", "wire"):
            snap.pop(bulky, None)
            body = json.dumps(
                snap, separators=(",", ":"), sort_keys=True
            ).encode()
            if len(body) <= SNAPSHOT_MAX_BYTES:
                break
    return b"%08x:%s" % (zlib.crc32(body), body)


def decode_fleet_entry(
    raw: Optional[bytes],
    now: Optional[float] = None,
    stale_after_s: float = STALE_AFTER_S,
) -> Optional[Dict[str, Any]]:
    """Parse one ``__obs/`` value; None for torn, malformed, or stale
    entries (a dead publisher's last snapshot ages out rather than
    rendering forever)."""
    if not raw:
        return None
    try:
        head, body = raw.split(b":", 1)
        if int(head, 16) != zlib.crc32(body):
            return None
        entry = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(entry, dict):
        return None
    t = entry.get("t")
    if not isinstance(t, (int, float)):
        return None
    entry["age_s"] = max(0.0, (time.time() if now is None else now) - t)
    if entry["age_s"] > stale_after_s:
        return None
    return entry


def publish_interval_for_world(world: int) -> float:
    """World-scaled publish pacing: a 4-rank job refreshes every 0.25s,
    a 1000-rank fleet backs off to 5s so the plane's store traffic
    stays a rounding error next to the real coordination load."""
    return max(0.25, min(5.0, max(1, world) * 0.02))


class FleetReporter:
    """One process's handle on the fleet plane: publishes ONE bounded
    snapshot key ``__obs/<role>/<id>`` (world-paced, ``multi_set``) and
    reaps it on :meth:`close` via ``multi_delete``."""

    def __init__(
        self,
        store: Any,
        role: str,
        ident: Any,
        world: int = 1,
        interval_s: Optional[float] = None,
    ) -> None:
        self._store = store
        self.key = f"{OBS_PREFIX}/{role}/{ident}"
        self._role = role
        self._ident = str(ident)
        self._seq = 0
        self._interval_s = (
            publish_interval_for_world(world)
            if interval_s is None
            else interval_s
        )
        self._last_pub = float("-inf")
        self._lock = threading.Lock()
        self._closed = False

    def publish(
        self,
        phase: Optional[str] = None,
        written_bytes: Optional[int] = None,
        extra: Optional[Mapping[str, Any]] = None,
        force: bool = False,
    ) -> bool:
        """Publish a fresh snapshot if the pacer allows it; returns
        whether anything was written.  Store errors are swallowed — the
        plane observes the job, it must never fail it."""
        with self._lock:
            if self._closed:
                return False
            now = time.monotonic()
            if not force and now - self._last_pub < self._interval_s:
                return False
            self._last_pub = now
            self._seq += 1
            seq = self._seq
        snap = fleet_snapshot(
            self._role,
            self._ident,
            seq,
            phase=phase,
            written_bytes=written_bytes,
            extra=extra,
        )
        try:
            self._store.multi_set({self.key: encode_fleet_entry(snap)})
        except Exception:  # noqa: BLE001 - observability is best-effort
            return False
        return True

    def close(self) -> None:
        """Reap this publisher's key so a clean shutdown leaves no
        residue under ``__obs/``."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._store.multi_delete([self.key])
        except Exception:  # noqa: BLE001 - teardown is best-effort
            pass


def collect_fleet(
    store: Any, stale_after_s: float = STALE_AFTER_S
) -> List[Dict[str, Any]]:
    """All live fleet entries on ``store``, torn/stale ones skipped,
    ordered by (role, id)."""
    keys = store.scan(OBS_PREFIX + "/")
    entries: List[Dict[str, Any]] = []
    if keys:
        for raw in store.multi_get(list(keys)).values():
            entry = decode_fleet_entry(raw, stale_after_s=stale_after_s)
            if entry is not None:
                entries.append(entry)
    entries.sort(key=lambda e: (str(e.get("role", "")), str(e.get("id", ""))))
    return entries


def render_fleet_table(entries: Sequence[Mapping[str, Any]]) -> str:
    """The live fleet table: one row per publisher with phase, written
    bytes, snapshot age, wire totals, dial p95, and a straggler flag
    (a publisher ≥ 2 sequence points behind the fleet head, or one
    whose snapshot is 3x staler than the median)."""
    if not entries:
        return "(no live fleet entries under __obs/)"
    ages = sorted(float(e.get("age_s", 0.0)) for e in entries)
    median_age = _percentile(ages, 0.5)
    max_seq = max(int(e.get("seq", 0)) for e in entries)
    header = (
        "ROLE",
        "ID",
        "SEQ",
        "PHASE",
        "WRITTEN",
        "AGE_S",
        "FRAMES",
        "WIRE_MB",
        "DIAL_P95_S",
        "BURN",
        "NOTE",
    )
    rows: List[Tuple[str, ...]] = [header]
    for e in entries:
        wire = e.get("wire") or {}
        eps = wire.get("endpoints") or {}
        frames = sum(float(ep.get("frames", 0)) for ep in eps.values())
        mb = sum(float(ep.get("bytes", 0)) for ep in eps.values()) / 1024**2
        age = float(e.get("age_s", 0.0))
        # The publisher's SLO burn rate rides the plane as an extra
        # (telemetry/slo.py): >= 1.0 means that member is spending its
        # error budget faster than sustainable.
        burn = (e.get("extra") or {}).get("slo_burn")
        notes = []
        if max_seq - int(e.get("seq", 0)) >= 2:
            notes.append("straggler")
        if len(entries) >= 3 and median_age > 0 and age > 3 * median_age:
            notes.append("stale")
        if isinstance(burn, (int, float)) and float(burn) >= 1.0:
            notes.append("burning")
        rows.append(
            (
                str(e.get("role", "?")),
                str(e.get("id", "?")),
                str(e.get("seq", "?")),
                str(e.get("phase", "-")),
                str(e.get("written_bytes", "-")),
                f"{age:.1f}",
                f"{frames:.0f}",
                f"{mb:.2f}",
                f"{float(wire.get('dial_p95_s', 0.0)):.3f}",
                f"{float(burn):.2f}"
                if isinstance(burn, (int, float))
                else "-",
                ",".join(notes) or "-",
            )
        )
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    return "\n".join(
        "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row)).rstrip()
        for row in rows
    )


def write_fleet_endpoint(root: str, host: str, port: int) -> str:
    """Advertise the coordination store's address under ``root`` so
    ``telemetry fleet <root>`` can find it (atomic rewrite)."""
    path = os.path.join(root, FLEET_ENDPOINT_BASENAME)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(f"{host}:{port}\n")
    os.replace(tmp, path)
    return path


def read_fleet_endpoint(root: str) -> Tuple[str, int]:
    path = os.path.join(root, FLEET_ENDPOINT_BASENAME)
    with open(path, "r", encoding="utf-8") as f:
        host, _, port = f.read().strip().rpartition(":")
    return host, int(port)


def open_fleet_store(target: str):
    """``host:port`` straight to the store; a directory goes through
    its advertised ``.fleet-endpoint`` file."""
    from ..dist_store import TCPStore

    if os.path.isdir(target):
        host, port = read_fleet_endpoint(target)
    else:
        host, _, port_s = target.rpartition(":")
        if not host:
            raise SystemExit(
                f"fleet target {target!r} is neither a directory with a "
                f"{FLEET_ENDPOINT_BASENAME} file nor host:port"
            )
        port = int(port_s)
    return TCPStore(host, port, is_server=False)


def fleet_main(argv: Sequence[str]) -> int:
    """``python -m torchsnapshot_tpu_torch.telemetry fleet <target>``."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch.telemetry fleet",
        description=(
            "Render the live fleet table from __obs/ snapshots on the "
            "coordination store and run the fleet-scope doctor rules."
        ),
    )
    parser.add_argument(
        "target",
        help="coordination store as host:port, or a snapshot root "
        f"containing {FLEET_ENDPOINT_BASENAME}",
    )
    parser.add_argument(
        "--once",
        action="store_true",
        help="render one table and exit (default: watch)",
    )
    parser.add_argument(
        "--interval", type=float, default=2.0, help="watch refresh seconds"
    )
    parser.add_argument(
        "--stale-after",
        type=float,
        default=STALE_AFTER_S,
        help="ignore snapshots older than this many seconds",
    )
    args = parser.parse_args(list(argv))
    from . import doctor

    store = open_fleet_store(args.target)
    try:
        while True:
            entries = collect_fleet(store, stale_after_s=args.stale_after)
            print(render_fleet_table(entries))
            verdicts = doctor.diagnose_fleet(entries)
            for verdict in verdicts:
                print(verdict.format())
            if args.once:
                break
            print(f"-- {len(entries)} publisher(s); ^C to stop --", flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        store.close()
    return 0
