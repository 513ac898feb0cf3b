"""Checkpoint flight recorder: an always-on bounded ring of spans.

Copy of the recorder half of ``torchsnapshot_tpu/telemetry/trace.py``:

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

The Chrome-trace export, the cross-rank merge and the stall watchdog
that scans the open spans are not part of this package yet.
"""

from __future__ import annotations

import contextlib
import logging
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
