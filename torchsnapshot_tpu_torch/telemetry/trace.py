"""Checkpoint flight recorder: span tracing + Chrome-trace export + merge.

Copy of ``torchsnapshot_tpu/telemetry/trace.py``:

- **Always-on bounded ring.** Every span/instant lands in a process-wide
  ring buffer (capacity knob, default 16384 completed events; oldest
  evict first, evictions counted). Recording is a lock plus a few dict
  ops, so it is never gated.
- **Thread- and asyncio-safe tracks.** A span's track is
  ``(thread, current asyncio task)``: concurrent coroutines on one event
  loop get distinct tracks, so begin/end pairs nest like the sequential
  code that emitted them.
- **Dual emission.** ``utils.tracing.trace_annotation`` call sites feed
  BOTH this recorder and (when a profiler session is active) the
  ``torch.profiler`` timeline.

- **Chrome trace-event export.** Per checkpoint operation (take /
  restore / async variants / mirror job), the op's event window is
  written as Perfetto-loadable Chrome trace JSON next to the snapshot
  (``<snapshot>/.trace-<kind>-rank<r>.json``) or into
  ``TORCHSNAPSHOT_TPU_TRACE_DIR``, in the JAX package's format: either
  package's ``merge_traces`` merges the other's files.
- **Cross-rank merge.** ``python -m torchsnapshot_tpu_torch.telemetry.trace
  <snapshot>`` merges the per-rank files into one trace (one pid per
  rank), correcting per-rank clock offsets measured by the report
  gather, and prints a straggler / longest-span summary.

The stall watchdog (watchdog.py) scans this recorder's open spans; the
first span's begin starts it.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import threading
import time
from collections import deque
from typing import (
    Any,
    Deque,
    Dict,
    Generator,
    List,
    NamedTuple,
    Optional,
    Tuple,
)

from .. import knobs
from . import names


logger: logging.Logger = logging.getLogger(__name__)

TRACE_BASENAME_PREFIX = "trace-"
SNAPSHOT_TRACE_PREFIX = ".trace-"
MERGED_TRACE_BASENAME = ".trace.merged.json"

def _now_us() -> int:
    return time.time_ns() // 1000


def _track_key() -> Tuple[int, int]:
    """(thread ident, asyncio task id): the unit within which spans are
    guaranteed to nest like sequential code."""
    import asyncio

    try:
        task = asyncio.current_task()
    except RuntimeError:
        task = None
    return (threading.get_ident(), id(task) if task is not None else 0)


class _OpenSpan:
    __slots__ = ("name", "begin_us", "bseq", "tid", "args", "stalled")

    def __init__(
        self, name: str, begin_us: int, bseq: int, tid: int, args: Dict
    ) -> None:
        self.name = name
        self.begin_us = begin_us
        self.bseq = bseq
        self.tid = tid
        self.args = args
        self.stalled = False


class TraceMark(NamedTuple):
    """Opaque cursor from :meth:`SpanRecorder.mark`: the completion
    sequence plus the eviction count at mark time (so an export can
    report drops within ITS window, not the recorder's lifetime)."""

    seq: int
    dropped: int


class SpanRecorder:
    """Bounded in-memory flight recorder. Use the module singleton via
    :func:`get_recorder`; direct construction is for tests.

    Completed events are dicts
    ``{"seq", "bseq", "ph" ("X"|"i"), "name", "ts", "dur", "tid",
    "args"}`` with ``ts``/``dur`` in unix-epoch microseconds; ``seq``
    orders completions (the ring's eviction order and the export-window
    cursor), ``bseq`` orders begins (what the Chrome exporter's B/E
    interleave sorts on).
    """

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._events: Deque[Dict[str, Any]] = deque(
            maxlen=capacity or knobs.get_trace_buffer_events()
        )
        self._open: Dict[int, _OpenSpan] = {}
        self._seq = 0
        self._next_token = 0
        self._tids: Dict[Tuple[int, int], int] = {}
        self._tid_names: Dict[int, str] = {}
        self.dropped = 0
        # Forward-progress clock: any begin/end/instant refreshes it.
        # The watchdog keys stall detection on this, not on open-span
        # age alone — an envelope span (snapshot:take) legitimately
        # stays open for minutes while events complete underneath.
        self._last_activity = time.monotonic()

    # -- recording -------------------------------------------------------

    def _tid_locked(self, key: Tuple[int, int]) -> int:
        tid = self._tids.get(key)
        if tid is None:
            tid = len(self._tids)
            self._tids[key] = tid
            label = threading.current_thread().name
            if key[1]:
                label = f"{label}:task-{len(self._tids)}"
            self._tid_names[tid] = label
        return tid

    def begin(self, name: str, **args: Any) -> int:
        """Open a span on the caller's track; returns a token for
        :meth:`end`."""
        key = _track_key()
        ts = _now_us()
        with self._lock:
            self._seq += 1
            self._next_token += 1
            self._last_activity = time.monotonic()
            token = self._next_token
            self._open[token] = _OpenSpan(
                name, ts, self._seq, self._tid_locked(key), args
            )
        # Outside the lock: may start the watchdog thread.
        from . import watchdog

        watchdog.ensure_started(self)
        return token

    def end(self, token: int, **extra_args: Any) -> None:
        ts = _now_us()
        with self._lock:
            span = self._open.pop(token, None)
            if span is None:
                return
            if extra_args:
                span.args.update(extra_args)
            self._seq += 1
            self._last_activity = time.monotonic()
            self._append_locked(
                {
                    "seq": self._seq,
                    "bseq": span.bseq,
                    "ph": "X",
                    "name": span.name,
                    "ts": span.begin_us,
                    # A zero-length span would sort its E before its own
                    # B in the ts-major export ordering.
                    "dur": max(1, ts - span.begin_us),
                    "tid": span.tid,
                    "args": span.args,
                }
            )

    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Generator[None, None, None]:
        token = self.begin(name, **args)
        try:
            yield
        finally:
            self.end(token)

    def instant(
        self, name: str, count_as_progress: bool = True, **args: Any
    ) -> None:
        """Point-in-time event. ``count_as_progress=False`` keeps the
        forward-progress clock untouched — the watchdog's own stall
        markers must not look like the stalled process doing work."""
        ts = _now_us()
        key = _track_key()
        with self._lock:
            self._seq += 1
            if count_as_progress:
                self._last_activity = time.monotonic()
            self._append_locked(
                {
                    "seq": self._seq,
                    "bseq": self._seq,
                    "ph": "i",
                    "name": name,
                    "ts": ts,
                    "tid": self._tid_locked(key),
                    "args": args,
                }
            )

    def _append_locked(self, event: Dict[str, Any]) -> None:
        if (
            self._events.maxlen is not None
            and len(self._events) == self._events.maxlen
        ):
            self.dropped += 1
        self._events.append(event)

    # -- reading ---------------------------------------------------------

    def idle_seconds(self) -> float:
        """Seconds since ANY event was recorded (begin/end/instant) —
        the watchdog's forward-progress signal. Near zero while a
        pipeline is moving, growing while everything is wedged."""
        with self._lock:
            return time.monotonic() - self._last_activity

    def mark(self) -> "TraceMark":
        """Cursor for a later :meth:`events_since` /
        :func:`export_op_trace`: everything completing after this call
        has ``seq`` greater than the marked value, and the mark carries
        the eviction count so exports can report window-local drops."""
        with self._lock:
            return TraceMark(self._seq, self.dropped)

    def events_since(self, mark: "int | TraceMark" = 0) -> List[Dict[str, Any]]:
        """Completed events newer than ``mark`` (a span that began before
        the mark but finished after it is included — overlap with the
        previous operation is signal, not noise), completion order."""
        seq = mark.seq if isinstance(mark, TraceMark) else mark
        with self._lock:
            return [dict(e) for e in self._events if e["seq"] > seq]

    def tid_names(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._tid_names)

    def open_spans(self) -> List[Dict[str, Any]]:
        """Snapshot of currently-open spans (watchdog + diagnostics):
        ``{"token", "name", "age_s", "tid", "thread", "args",
        "stalled"}``, oldest first."""
        now = _now_us()
        with self._lock:
            out = [
                {
                    "token": token,
                    "name": s.name,
                    "age_s": round((now - s.begin_us) / 1e6, 3),
                    "tid": s.tid,
                    "thread": self._tid_names.get(s.tid, "?"),
                    "args": dict(s.args),
                    "stalled": s.stalled,
                }
                for token, s in self._open.items()
            ]
        out.sort(key=lambda s: -s["age_s"])
        return out

    def flag_stalled(self, token: int) -> bool:
        """Mark one open span as stall-flagged; False if it already was
        (or has since closed) — the watchdog's fire-once latch."""
        with self._lock:
            span = self._open.get(token)
            if span is None or span.stalled:
                return False
            span.stalled = True
            return True

    def reset(self) -> None:
        """Drop everything, re-reading the capacity knob (tests
        simulating a fresh process)."""
        with self._lock:
            self._events = deque(maxlen=knobs.get_trace_buffer_events())
            self._open.clear()
            self._seq = 0
            self._tids.clear()
            self._tid_names.clear()
            self.dropped = 0


_RECORDER: Optional[SpanRecorder] = None
_RECORDER_INIT = threading.Lock()


def get_recorder() -> SpanRecorder:
    """The process-wide flight recorder every instrumented layer records
    into. Lazily constructed so the capacity knob is read at first use,
    not at import."""
    global _RECORDER
    rec = _RECORDER
    if rec is None:
        with _RECORDER_INIT:
            if _RECORDER is None:
                _RECORDER = SpanRecorder()
            rec = _RECORDER
    return rec


def io_span(
    plugin: str,
    op: str,
    blob: str,
    nbytes: Optional[int] = None,
    byte_range: Optional[Tuple[int, int]] = None,
):
    """Recorder span for one storage operation — the shared
    instrumentation hook for the fs/s3/gcs plugins (the recorder-side
    sibling of ``telemetry.observe_io``)."""
    args: Dict[str, Any] = {"plugin": plugin, "blob": blob}
    if nbytes is not None:
        args["bytes"] = int(nbytes)
    if byte_range is not None:
        args["range"] = [int(byte_range[0]), int(byte_range[1])]
    name = names.SPAN_STORAGE_WRITE if op == "write" else names.SPAN_STORAGE_READ
    return get_recorder().span(name, **args)

# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------


def _event_sort_key(ev: Dict[str, Any]) -> Tuple[int, int, int]:
    """Total order that keeps every track's B/E stack valid: ts-major;
    at equal ts, E before B/i (a span ending exactly where a sibling
    begins must close first); E ties resolve innermost-first (larger
    begin-seq), B ties outermost-first (smaller begin-seq)."""
    if ev["ph"] == "E":
        return (ev["ts"], 0, -ev["bseq"])
    return (ev["ts"], 1, ev["bseq"])


def chrome_trace(
    events: List[Dict[str, Any]],
    tid_names: Dict[int, str],
    rank: int = 0,
    dropped: int = 0,
) -> Dict[str, Any]:
    """Recorder events -> a Chrome trace-event JSON document (one pid =
    this rank; balanced B/E pairs, ts-sorted; Perfetto-loadable)."""
    pid = rank
    out: List[Dict[str, Any]] = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": pid,
            "tid": 0,
            "ts": 0,
            "args": {"name": f"rank{rank}"},
        }
    ]
    used_tids = sorted({e["tid"] for e in events})
    for tid in used_tids:
        out.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": pid,
                "tid": tid,
                "ts": 0,
                "args": {"name": tid_names.get(tid, f"thread-{tid}")},
            }
        )
    flat: List[Dict[str, Any]] = []
    for e in events:
        if e["ph"] == "X":
            flat.append(
                {
                    "ph": "B",
                    "name": e["name"],
                    "pid": pid,
                    "tid": e["tid"],
                    "ts": e["ts"],
                    "bseq": e["bseq"],
                    "args": e["args"],
                }
            )
            flat.append(
                {
                    "ph": "E",
                    "name": e["name"],
                    "pid": pid,
                    "tid": e["tid"],
                    "ts": e["ts"] + e["dur"],
                    "bseq": e["bseq"],
                }
            )
        else:
            flat.append(
                {
                    "ph": "i",
                    "s": "t",
                    "name": e["name"],
                    "pid": pid,
                    "tid": e["tid"],
                    "ts": e["ts"],
                    "bseq": e["bseq"],
                    "args": e["args"],
                }
            )
    flat.sort(key=_event_sort_key)
    for ev in flat:
        del ev["bseq"]  # ordering scaffold only; not Chrome schema
    out.extend(flat)
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "rank": rank,
            "clock": "unix_epoch_us",
            "dropped_events": dropped,
            "exported_unix_ts": round(time.time(), 6),
        },
    }


def write_trace_file(path: str, doc: Dict[str, Any]) -> None:
    """Atomic write (tmp + rename): a concurrent reader/merger never
    sees a torn trace."""
    from .sink import atomic_write_text

    atomic_write_text(path, json.dumps(doc, separators=(",", ":")))


def trace_path_for(
    snapshot_path: Optional[str], kind: str, rank: int
) -> Optional[str]:
    """Where an operation's trace export should go, or None when no
    trace sink is configured (same resolution order as the JSONL report
    sink: explicit dir knob first, then the snapshot-adjacent file for
    local paths)."""
    trace_dir = knobs.get_trace_dir()
    if trace_dir:
        return os.path.join(
            trace_dir, f"{TRACE_BASENAME_PREFIX}{kind}-rank{rank}.json"
        )
    if not knobs.is_trace_sink_enabled():
        return None
    from .sink import local_fs_root

    root = local_fs_root(snapshot_path)
    if root is None:
        return None
    return os.path.join(
        root, f"{SNAPSHOT_TRACE_PREFIX}{kind}-rank{rank}.json"
    )


def export_op_trace(
    kind: str, snapshot_path: str, rank: int, mark: "int | TraceMark"
) -> Optional[str]:
    """Write one operation's event window as a Chrome trace file;
    returns the path, or None (sink off / local root unavailable).
    Best-effort: trace export must never fail a checkpoint."""
    try:
        path = trace_path_for(snapshot_path, kind, rank)
        if path is None:
            return None
        recorder = get_recorder()
        dropped_baseline = (
            mark.dropped if isinstance(mark, TraceMark) else 0
        )
        doc = chrome_trace(
            recorder.events_since(mark),
            recorder.tid_names(),
            rank=rank,
            # Evictions within this op's window only, not the
            # recorder's lifetime total.
            dropped=max(0, recorder.dropped - dropped_baseline),
        )
        write_trace_file(path, doc)
        return path
    except Exception as e:  # noqa: BLE001 - telemetry must not fail the op
        logger.warning("trace: could not export %s trace: %r", kind, e)
        return None


# ---------------------------------------------------------------------------
# Cross-rank merge + summaries
# ---------------------------------------------------------------------------


def find_trace_files(snapshot_path: str) -> List[str]:
    """Per-rank trace files recorded for one snapshot: the
    snapshot-adjacent ``.trace-*.json`` plus, when a trace dir is
    configured, its ``trace-*.json`` exports."""
    out: List[str] = []
    from .sink import local_fs_root

    root = local_fs_root(snapshot_path)
    if root is None and "://" not in snapshot_path:
        root = snapshot_path
    if root is not None:
        out.extend(
            sorted(glob.glob(os.path.join(root, f"{SNAPSHOT_TRACE_PREFIX}*.json")))
        )
    trace_dir = knobs.get_trace_dir()
    if trace_dir:
        out.extend(
            sorted(glob.glob(os.path.join(trace_dir, f"{TRACE_BASENAME_PREFIX}*.json")))
        )
    return [p for p in out if not p.endswith(MERGED_TRACE_BASENAME)]


def merge_traces(
    paths: List[str],
    clock_offsets_s: Optional[Dict[int, float]] = None,
) -> Dict[str, Any]:
    """Merge per-rank Chrome trace files into one document: each file's
    events keep their pid (= rank) and have ``clock_offsets_s[rank]``
    subtracted from their timestamps (the store-gather-measured skew of
    that rank's clock against rank 0). Two files claiming the same rank
    (e.g. two co-hosted processes' mirror exports) get distinct pids —
    overlaying them on one pid would interleave their tracks and tear
    the B/E stacks. The concatenation is stable-sorted by ts only, so
    each (pid, tid) track's internal order — and hence its B/E balance
    — is preserved verbatim."""
    merged: List[Dict[str, Any]] = []
    ranks: List[int] = []
    used_pids: set = set()
    unaligned: List[int] = []
    dropped = 0
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        other = doc.get("otherData", {})
        rank = int(other.get("rank", 0))
        ranks.append(rank)
        pid = rank
        while pid in used_pids:
            pid += 1
        used_pids.add(pid)
        dropped += int(other.get("dropped_events", 0))
        shift_us = 0
        if clock_offsets_s:
            offset = clock_offsets_s.get(rank)
            if offset is None:
                # A rank whose report carried no clock offset (older
                # schema, or it never reached the gather) merges
                # uncorrected rather than failing the whole merge —
                # its pid is simply unaligned, and flagged as such.
                unaligned.append(rank)
                logger.warning(
                    "trace merge: no clock offset for rank %d; its "
                    "timeline is unaligned",
                    rank,
                )
            else:
                shift_us = int(round(offset * 1e6))
        for ev in doc.get("traceEvents", []):
            if shift_us != 0 or pid != ev.get("pid", rank):
                ev = dict(ev)
                if shift_us and ev.get("ph") != "M":
                    ev["ts"] = ev["ts"] - shift_us
                ev["pid"] = pid
            merged.append(ev)
    merged.sort(key=lambda ev: ev["ts"])
    out = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "ranks": sorted(set(ranks)),
            "clock": "unix_epoch_us (rank offsets applied)"
            if clock_offsets_s
            else "unix_epoch_us (no rank offset correction)",
            "dropped_events": dropped,
        },
    }
    if unaligned:
        out["otherData"]["unaligned_ranks"] = sorted(set(unaligned))
    stitch_wire_flows(out)
    return out


def stitched_wire_pairs(
    doc: Dict[str, Any]
) -> List[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """(client RPC span, server handler span) pairs causally linked by
    the propagated wire context: the handler's ``parent_span_id``
    equals the client span's ``span_id`` and both carry the same trace
    id. Works on a single rank's doc or a merged one — the linkage
    rides span args, not pids."""
    spans = spans_from_chrome(doc)
    clients: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        if s["name"] == names.SPAN_WIRE_RPC:
            span_id = s.get("args", {}).get("span_id")
            if span_id:
                clients[str(span_id)] = s
    pairs: List[Tuple[Dict[str, Any], Dict[str, Any]]] = []
    for s in spans:
        if s["name"] != names.SPAN_WIRE_HANDLER:
            continue
        args = s.get("args", {})
        client = clients.get(str(args.get("parent_span_id")))
        if client is None:
            continue
        if client.get("args", {}).get("trace_id") == args.get("trace_id"):
            pairs.append((client, s))
    return pairs


def stitch_wire_flows(doc: Dict[str, Any]) -> int:
    """Append Chrome flow events (``ph: s`` / ``ph: f``) linking each
    cross-process client→handler wire pair, so Perfetto draws the RPC
    arrow from the caller's span to the serving peer's handler span.
    Returns the number of stitched pairs (also recorded in
    ``otherData.wire_stitched``)."""
    pairs = stitched_wire_pairs(doc)
    events = doc.setdefault("traceEvents", [])
    for client, handler in pairs:
        flow_id = str(client["args"]["span_id"])
        common = {"cat": "wire", "name": "wire-rpc", "id": flow_id}
        # Flow endpoints must land INSIDE their slices (ts + 1 beats
        # the >= 1 us minimum span duration) or Perfetto drops them.
        events.append(
            {
                "ph": "s",
                "pid": client["pid"],
                "tid": client["tid"],
                "ts": client["ts"] + 1,
                **common,
            }
        )
        events.append(
            {
                "ph": "f",
                "bp": "e",
                "pid": handler["pid"],
                "tid": handler["tid"],
                "ts": handler["ts"] + 1,
                **common,
            }
        )
    doc.setdefault("otherData", {})["wire_stitched"] = len(pairs)
    return len(pairs)


def spans_from_chrome(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Reconstruct completed spans from a Chrome trace document's B/E
    pairs: ``{"name", "pid", "tid", "ts", "dur_us", "self_us"}``.
    ``self_us`` is the span's inclusive duration minus the durations of
    its direct children on the same track — the time the span spent in
    its OWN frame, which is what separates a genuinely slow stage from
    an envelope that merely contains one."""
    # Stack entries are [begin_event, accumulated_child_us].
    stacks: Dict[Tuple[int, int], List[List[Any]]] = {}
    spans: List[Dict[str, Any]] = []
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        key = (ev.get("pid", 0), ev.get("tid", 0))
        if ph == "B":
            stacks.setdefault(key, []).append([ev, 0])
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                continue  # torn window: span began before the export mark
            begin, child_us = stack.pop()
            dur_us = ev["ts"] - begin["ts"]
            if stack:
                stack[-1][1] += dur_us
            spans.append(
                {
                    "name": begin.get("name", "?"),
                    "pid": key[0],
                    "tid": key[1],
                    "ts": begin["ts"],
                    "dur_us": dur_us,
                    "self_us": max(0, dur_us - child_us),
                    "args": begin.get("args", {}),
                }
            )
    return spans


def longest_spans_from_doc(
    doc: Dict[str, Any], n: int = 3
) -> List[Dict[str, Any]]:
    """Top-``n`` longest spans of an already-loaded trace document —
    for callers (the checkpoint doctor) that also scan the same doc for
    other events and must not parse a multi-MB trace twice."""
    spans = sorted(spans_from_chrome(doc), key=lambda s: -s["dur_us"])
    out = []
    for s in spans[:n]:
        entry = {
            "name": s["name"],
            "dur_ms": round(s["dur_us"] / 1000, 1),
            "self_ms": round(s.get("self_us", s["dur_us"]) / 1000, 1),
        }
        blob = s.get("args", {}).get("blob")
        if blob:
            entry["blob"] = blob
        out.append(entry)
    return out


def longest_spans(
    trace_path: str, n: int = 3
) -> List[Dict[str, Any]]:
    """Top-``n`` longest spans of one trace file, for embedding in
    stall diagnoses (bench.py): ``{"name", "dur_ms", "blob"?}``."""
    with open(trace_path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    return longest_spans_from_doc(doc, n)


def summarize_merged(doc: Dict[str, Any], top: int = 5) -> str:
    """Operator summary of a merged trace: per-rank wall extent, the
    longest individual spans, the per-span-name straggler rank (largest
    total duration), and any watchdog stall events."""
    spans = spans_from_chrome(doc)
    lines: List[str] = []
    if not spans:
        return "no spans in trace"
    ranks = sorted({s["pid"] for s in spans})
    t0 = min(s["ts"] for s in spans)
    for rank in ranks:
        rs = [s for s in spans if s["pid"] == rank]
        begin = min(s["ts"] for s in rs)
        end = max(s["ts"] + s["dur_us"] for s in rs)
        lines.append(
            f"rank {rank}: {len(rs)} spans, window "
            f"[{(begin - t0) / 1e3:.1f} .. {(end - t0) / 1e3:.1f}] ms"
        )
    lines.append("")
    lines.append(f"longest spans (top {top}, inclusive / self):")
    for s in sorted(spans, key=lambda s: -s["dur_us"])[:top]:
        blob = s.get("args", {}).get("blob")
        suffix = f" ({blob})" if blob else ""
        lines.append(
            f"  {s['name']:<32} rank {s['pid']} "
            f"{s['dur_us'] / 1e3:>10.1f} ms / "
            f"{s.get('self_us', s['dur_us']) / 1e3:.1f} ms self{suffix}"
        )
    lines.append("")
    lines.append(f"top self-time spans (top {top}):")
    for s in sorted(
        spans, key=lambda s: -s.get("self_us", s["dur_us"])
    )[:top]:
        lines.append(
            f"  {s['name']:<32} rank {s['pid']} "
            f"{s.get('self_us', s['dur_us']) / 1e3:>10.1f} ms self "
            f"(of {s['dur_us'] / 1e3:.1f} ms)"
        )
    if len(ranks) > 1:
        totals: Dict[str, Dict[int, float]] = {}
        for s in spans:
            totals.setdefault(s["name"], {}).setdefault(s["pid"], 0.0)
            totals[s["name"]][s["pid"]] += s["dur_us"]
        lines.append("")
        lines.append("per-span straggler (max total duration across ranks):")
        for name in sorted(totals):
            per_rank = totals[name]
            straggler = max(per_rank, key=lambda r: per_rank[r])
            lines.append(
                f"  {name:<32} rank {straggler} "
                f"({per_rank[straggler] / 1e3:.1f} ms; min "
                f"{min(per_rank.values()) / 1e3:.1f} ms)"
            )
    pairs = stitched_wire_pairs(doc)
    if pairs:
        lines.append("")
        lines.append(f"wire RPCs stitched across processes: {len(pairs)}")
        for client, handler in pairs[:top]:
            op = client.get("args", {}).get("op", "?")
            lines.append(
                f"  {op:<24} pid {client['pid']} -> pid {handler['pid']} "
                f"({client['dur_us'] / 1e3:.1f} ms round trip)"
            )
    stalls = [
        ev
        for ev in doc.get("traceEvents", [])
        if ev.get("ph") == "i"
        and ev.get("name") == names.INSTANT_WATCHDOG_STALL
    ]
    if stalls:
        lines.append("")
        lines.append(f"WATCHDOG STALLS: {len(stalls)}")
        for ev in stalls:
            args = ev.get("args", {})
            lines.append(
                f"  rank {ev.get('pid', 0)} @ +{(ev['ts'] - t0) / 1e3:.1f} ms: "
                f"{args.get('span', '?')} open {args.get('age_s', '?')}s"
            )
    return "\n".join(lines)


def _clock_offsets_from_events(roots: List[str]) -> Dict[int, float]:
    """Per-rank clock offsets recorded by the newest aggregated
    SnapshotReport found in the JSONL sinks under ``roots`` (see
    report.clock_offsets_s). Empty dict = no correction available."""
    from .sink import EVENTS_BASENAME, SNAPSHOT_EVENTS_BASENAME, load_events

    candidates: List[str] = []
    for root in roots:
        for base in (SNAPSHOT_EVENTS_BASENAME, EVENTS_BASENAME):
            p = os.path.join(root, base)
            if os.path.exists(p):
                candidates.append(p)
    best: Dict[int, float] = {}
    for path in candidates:
        try:
            for ev in load_events(path):
                offsets = ev.get("clock_offsets_s")
                if offsets:
                    # A rank whose slot is null (no gather stamp) gets
                    # no entry: merge_traces leaves it unaligned with a
                    # warning instead of failing the merge.
                    best = {
                        i: float(o)
                        for i, o in enumerate(offsets)
                        if o is not None
                    }
        except Exception:  # noqa: BLE001 - offsets are an optional refinement
            continue
    return best


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m torchsnapshot_tpu_torch.telemetry.trace <snapshot>``:
    merge per-rank trace files and print the straggler summary."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch.telemetry.trace",
        description="Merge per-rank checkpoint flight-recorder traces "
        "into one Chrome trace-event JSON (load in Perfetto / "
        "chrome://tracing) and summarize stragglers.",
    )
    p.add_argument(
        "path",
        help="snapshot directory (or trace dir) holding per-rank "
        ".trace-*.json / trace-*.json files, or a single trace file",
    )
    p.add_argument(
        "-o",
        "--output",
        default=None,
        help="merged trace output (default: <path>/.trace.merged.json)",
    )
    p.add_argument(
        "--top", type=int, default=5, help="longest spans to list"
    )
    p.add_argument(
        "--no-clock-offsets",
        action="store_true",
        help="skip the SnapshotReport-derived per-rank clock correction",
    )
    args = p.parse_args(argv)

    if os.path.isfile(args.path):
        files = [args.path]
        root = os.path.dirname(args.path) or "."
    else:
        files = find_trace_files(args.path)
        root = args.path
    if not files:
        print(
            f"telemetry trace: no trace files under {args.path!r} "
            f"(take with TORCHSNAPSHOT_TPU_TRACE=1 or set "
            f"TORCHSNAPSHOT_TPU_TRACE_DIR)"
        )
        return 1
    offsets: Dict[int, float] = {}
    if not args.no_clock_offsets:
        offsets = _clock_offsets_from_events([root])
    merged = merge_traces(files, offsets)
    out_path = args.output or os.path.join(root, MERGED_TRACE_BASENAME)
    write_trace_file(out_path, merged)
    print(f"merged {len(files)} trace file(s) -> {out_path}")
    if offsets and any(offsets.values()):
        print(
            "clock offsets applied (s): "
            + ", ".join(f"rank{r}={o:+.3f}" for r, o in sorted(offsets.items()))
        )
    unaligned = merged.get("otherData", {}).get("unaligned_ranks")
    if unaligned:
        print(
            f"warning: no clock offsets for rank(s) "
            f"{', '.join(map(str, unaligned))} — their timelines are "
            f"unaligned (raw clocks)"
        )
    stitched = merged.get("otherData", {}).get("wire_stitched", 0)
    if stitched:
        print(f"wire RPCs stitched across processes: {stitched}")
    print()
    print(summarize_merged(merged, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
