"""Stall watchdog over the flight recorder's open spans.

Copy of ``torchsnapshot_tpu/telemetry/watchdog.py``. A take that wedges
(a storage write that never returns) otherwise leaves nothing that
attributes its wall time. The watchdog turns such stalls into
artifacts: a daemon thread periodically snapshots the recorder's open
spans, and when some span has been open longer than the knob-set
deadline (``TORCHSNAPSHOT_TPU_WATCHDOG_SECONDS``, default 60 s; <= 0
disables — the test conftest sets 0 so the fast suite never pays for
it) AND the recorder has gone that long without recording ANY event —
i.e. work is wedged, not merely long (a healthy multi-minute take
completes per-blob spans continuously and never trips this) — it

- emits a ``watchdog:stall`` instant event into the recorder (so the
  stall lands on the exported timeline, inside the very trace that
  shows the hung span),
- logs the full open-span tree plus faulthandler-style stacks of every
  live thread (where exactly each thread is wedged),
- increments the ``watchdog_stalls_total`` counter.

Firing is **edge-triggered per stall episode**: the first scan that
observes the stalled-and-idle condition fires once; while the same
stall persists, subsequent scans stay quiet; once progress resumes (or
nothing over-deadline remains open) the trigger re-arms. A single hung
write therefore bumps the counter exactly once regardless of how many
enclosing spans (take -> pipeline -> storage) crossed the deadline
with it, and a later, distinct hang — even inside the same take —
fires again.

The thread starts lazily on the first recorded span (and only when the
deadline knob is positive at that moment); it re-reads the knob every
scan, so test overrides apply to a live thread.

A scan takes only the recorder's lock, for a copy of the open-span table:
it never waits on the drain thread, a CUDA stream or the storage event
loop. The stack dump drops its frame references before it returns, so a
stall report never keeps a frame's tensors (card memory included) alive.
"""

from __future__ import annotations

import logging
import sys
import threading
import traceback
from typing import TYPE_CHECKING, Dict, List, Optional

from .. import knobs
from . import names

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .trace import SpanRecorder

logger: logging.Logger = logging.getLogger(__name__)

_MIN_SCAN_PERIOD_S = 0.05
# A scan is a lock + a snapshot of the (small) open-span table, so even
# a 60 s deadline scans at 1 Hz: stalls are detected within deadline+1s,
# and a knob override (tests shrinking the deadline on a live thread)
# takes effect within a second rather than a deadline/4 sleep later.
_MAX_SCAN_PERIOD_S = 1.0
_IDLE_SCAN_PERIOD_S = 1.0


def _thread_stacks() -> str:
    """Faulthandler-style dump of every live thread's Python stack
    (minus the watchdog's own)."""
    names_by_ident = {t.ident: t.name for t in threading.enumerate()}
    me = threading.get_ident()
    chunks: List[str] = []
    frames = sys._current_frames()
    try:
        for ident, frame in frames.items():
            if ident == me:
                continue
            label = names_by_ident.get(ident, "?")
            stack = "".join(traceback.format_stack(frame))
            chunks.append(f"Thread {label} (ident {ident}):\n{stack}")
    finally:
        # A frame holds its locals: drop every reference before the
        # stall report is logged.
        frame = None
        del frames
    return "\n".join(chunks)


def _progress_rows() -> List[str]:
    """Compact per-op live-progress lines for the stall instant/log:
    how far each active operation got when the process wedged."""
    from .progress import current_progress

    rows: List[str] = []
    try:
        for p in current_progress()[:8]:
            rows.append(
                f"{p['kind']} rank{p['rank']} {p['phase']}: "
                f"{p['written_bytes']}/{p['planned_bytes']}B "
                f"items {p['items_done']}/{p['planned_items']} "
                f"(inflight {p['items_inflight']}, "
                f"budget_wait {p['budget_wait_s']}s)"
            )
    except Exception as e:  # noqa: BLE001 - the stall report must land
        rows.append(f"(progress unavailable: {e!r})")
    return rows


def _span_tree(open_spans: List[Dict]) -> str:
    """Open spans grouped per track, indented by begin order — the
    'what is the process inside right now' view."""
    by_track: Dict[str, List[Dict]] = {}
    for span in open_spans:
        by_track.setdefault(span["thread"], []).append(span)
    lines: List[str] = []
    for track in sorted(by_track):
        lines.append(f"  track {track}:")
        spans = sorted(by_track[track], key=lambda s: -s["age_s"])
        for depth, span in enumerate(spans):
            args = span.get("args") or {}
            arg_str = (
                " " + ", ".join(f"{k}={v}" for k, v in sorted(args.items()))
                if args
                else ""
            )
            lines.append(
                f"  {'  ' * (depth + 1)}{span['name']} "
                f"(open {span['age_s']}s{arg_str})"
            )
    return "\n".join(lines)


class StallWatchdog:
    """One scanning thread per process; see the module docstring."""

    def __init__(self, recorder: "SpanRecorder") -> None:
        self._recorder = recorder
        self._stop = threading.Event()
        self._in_stall = False
        self._thread = threading.Thread(
            target=self._run, name="ts-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        while True:
            deadline = knobs.get_watchdog_deadline_seconds()
            if deadline > 0:
                period = min(
                    _MAX_SCAN_PERIOD_S,
                    max(_MIN_SCAN_PERIOD_S, deadline / 4.0),
                )
                try:
                    self._scan(deadline)
                except Exception as e:  # noqa: BLE001 - must not die
                    logger.warning("watchdog scan failed: %r", e)
            else:
                # Disabled: re-arm so a later enable sees fresh state.
                self._in_stall = False
                period = _IDLE_SCAN_PERIOD_S
            if self._stop.wait(period):
                return

    def _scan(self, deadline_s: float) -> None:
        # A stall is spans stuck open with NO forward progress: an
        # envelope span (snapshot:take) legitimately stays open for
        # minutes while writes complete underneath it, and the recorder's
        # activity clock ticks on every one of those completions. Both
        # conditions must exceed the deadline to fire.
        idle_s = self._recorder.idle_seconds()
        open_spans = self._recorder.open_spans()
        stalled = [s for s in open_spans if s["age_s"] > deadline_s]
        if not stalled or idle_s <= deadline_s:
            # Progress resumed (or nothing is open): the episode is
            # over and a later, distinct stall fires again.
            self._in_stall = False
            return
        if self._in_stall:
            return  # same episode: already fired
        self._in_stall = True
        for s in stalled:
            self._recorder.flag_stalled(s["token"])
        # Attribute the stall to the deepest (youngest) over-deadline
        # span: that's where the wall time is actually going.
        culprit = min(stalled, key=lambda s: s["age_s"])
        tree = _span_tree(open_spans)
        # Live-progress snapshot of every active op: the stall report
        # says how FAR each op got (bytes written vs planned, in-flight
        # items), not just which spans are open.
        progress_rows = _progress_rows()
        # The critical-path prefix at stall time: the culprit's track's
        # open spans oldest -> youngest — the chain of frames gating the
        # op RIGHT NOW, ending in the culprit. Paired with
        # critpath.segment_for it names the path segment the stall is
        # charged to, so a frozen op reads the same way in the stall
        # instant as in a post-hoc ``critical_path`` report.
        from .critpath import segment_for

        track = [
            s for s in open_spans if s["tid"] == culprit["tid"]
        ]
        critical_prefix = [
            f"{s['name']}@{s['age_s']}s" for s in track[:16]
        ]
        # One black box per stall episode (``_in_stall`` above IS the
        # episode edge): freeze the evidence while the stall is live,
        # before progress resumes and overwrites it. The watchdog has
        # no root of its own — it captures for the first root this
        # process opened a run ledger at; best-effort + rate-limited.
        bundle_path = ""
        try:
            from . import bundle as bundle_mod

            capture_root = bundle_mod.default_capture_root()
            if capture_root is not None:
                bundle_path = (
                    bundle_mod.capture_bundle(
                        capture_root,
                        trigger="watchdog-stall",
                        reason=(
                            f"span {culprit['name']} open "
                            f"{culprit['age_s']}s"
                        ),
                    )
                    or ""
                )
        except Exception as e:  # noqa: BLE001 - capture must not kill the scan
            logger.warning("watchdog: bundle capture failed: %r", e)
        # count_as_progress=False: the stall marker itself must not
        # reset the idle clock and make the stall look resolved.
        self._recorder.instant(
            names.INSTANT_WATCHDOG_STALL,
            count_as_progress=False,
            span=culprit["name"],
            age_s=culprit["age_s"],
            idle_s=round(idle_s, 3),
            thread=culprit["thread"],
            deadline_s=deadline_s,
            critical_path=critical_prefix,
            gating_segment=segment_for(culprit["name"]),
            open_spans=[
                f"{s['name']}@{s['age_s']}s" for s in open_spans[:16]
            ],
            progress=progress_rows,
            bundle=bundle_path,
        )
        from . import metrics

        metrics().counter_inc(names.WATCHDOG_STALLS_TOTAL)
        logger.error(
            "watchdog: span %r open for %.1fs with no recorder activity "
            "for %.1fs (deadline %.1fs); gating segment %s, critical "
            "path %s; incident bundle %s; open-span tree:\n%s\n"
            "op progress:\n%s\nthread stacks:\n%s",
            culprit["name"],
            culprit["age_s"],
            idle_s,
            deadline_s,
            segment_for(culprit["name"]),
            " -> ".join(critical_prefix) or "(none)",
            bundle_path or "(not captured)",
            tree,
            "\n".join(f"  {row}" for row in progress_rows) or "  (none)",
            _thread_stacks(),
        )


_WATCHDOG: Optional[StallWatchdog] = None
_WATCHDOG_LOCK = threading.Lock()


def ensure_started(recorder: "SpanRecorder") -> None:
    """Start the watchdog once, lazily, from the recorder's span path.
    A non-positive deadline knob keeps it unstarted (no thread at all
    in the default test environment)."""
    global _WATCHDOG
    if _WATCHDOG is not None:
        return
    if knobs.get_watchdog_deadline_seconds() <= 0:
        return
    with _WATCHDOG_LOCK:
        if _WATCHDOG is None:
            _WATCHDOG = StallWatchdog(recorder)


def reset_watchdog() -> None:
    """Stop and discard the process watchdog (tests)."""
    global _WATCHDOG
    with _WATCHDOG_LOCK:
        watchdog, _WATCHDOG = _WATCHDOG, None
    if watchdog is not None:
        watchdog.stop()
