"""The device's idle gaps labelled by the program's own spans.

The program keeps an always-on flight recorder
(``torchsnapshot_tpu_torch.telemetry.trace``): spans per thread and
asyncio task, stamped in microseconds since the epoch on the same host
clock as the benchmark's spans. ``LabelledProfile`` marks the recorder
when the window opens and, when the trace is reduced, moves the
window's recorder spans onto the profiler's time base with the shift
the benchmark's spans take. ``summarize_labelled`` then labels each idle
gap ``<benchmark span>/<program span>``:

- the program span is the innermost (latest begun) recorder span on the
  window's main thread, the one that launches onto the card, that
  covers the gap's midpoint;
- failing that, the innermost one on any other thread, written
  ``<thread name without its numeric suffix>:<span>``, such as
  ``drain/snapshot-commit:storage:write``;
- failing that, the benchmark's label alone.

It adds ``idle_by_span`` and ``labelled_s``. For these every gap is cut
where a benchmark or program span starts or ends, and each piece is
labelled as above by the spans around its midpoint, so that a long gap
in which the writes, the commit and the bookkeeping ran one after
another counts each by its own seconds: ``idle_by_span`` is the idle
seconds by label (top 10), ``labelled_s`` for each benchmark label its
idle seconds that a program span labels and all its idle seconds. Fed no
program spans it returns ``trace.summarize``'s dict unchanged.
"""

from __future__ import annotations

import bisect
import heapq
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .trace import ANCHOR, Profile, summarize

# (start_ns, end_ns, begin order, label)
Interval = Tuple[int, int, int, str]
_SUFFIX = re.compile(r"(:task-\d+|[_-]\d+)+$")


def thread_base(name: str) -> str:
    """A recorder track's thread name without its numeric suffix:
    ``asyncio_3`` -> ``asyncio``, ``snapshot-commit:task-7`` ->
    ``snapshot-commit``."""
    return _SUFFIX.sub("", name) or name


def _gaps(dev: List[Tuple[int, int, str]], w0: int, w1: int) -> List[Tuple[int, int]]:
    """The window's idle intervals, as ``trace.summarize`` finds them."""
    gaps, covered = [], w0
    for a, b, _ in sorted(dev):
        if a > covered:
            gaps.append((covered, a))
        covered = max(covered, b)
    if w1 > covered:
        gaps.append((covered, w1))
    return gaps


def _latest_covering(intervals: Sequence[Interval], mids: Sequence[int]) -> List[Optional[str]]:
    """For each of ``mids`` (ascending) the label of the latest begun
    interval with ``start <= mid < end``, or None."""
    order = sorted(intervals, key=lambda iv: (iv[0], iv[2]))
    active: List[int] = []  # indices into order, in begin order
    ends: List[Tuple[int, int]] = []  # heap of (end, index)
    gone = set()
    out: List[Optional[str]] = []
    i = 0
    for mid in mids:
        while i < len(order) and order[i][0] <= mid:
            active.append(i)
            heapq.heappush(ends, (order[i][1], i))
            i += 1
        while ends and ends[0][0] <= mid:
            gone.add(heapq.heappop(ends)[1])
        while active and active[-1] in gone:
            active.pop()
        out.append(order[active[-1]][3] if active else None)
    return out


def summarize_labelled(
    dev: List[Tuple[int, int, str]], w0: int, w1: int, spans: List[Tuple[str, int, int]],
    main: Sequence[Interval] = (), others: Sequence[Interval] = (), kernels: Sequence[Any] = (),
) -> Dict[str, Any]:
    """``trace.summarize`` with the idle gaps also labelled by the program
    spans around them: ``main`` holds the main thread's recorder spans,
    ``others`` every other thread's, their labels already
    ``<thread>:<span>``, all on the profiler's time base; ``kernels`` as
    ``summarize`` takes it."""
    base = summarize(dev, w0, w1, spans, kernels)
    if not main and not others:
        return base
    # The benchmark's spans run one after another: the latest begun one
    # covering a midpoint is the only one, as summarize takes it.
    harness = [(s, e, k, n) for k, (n, s, e) in enumerate(spans)]

    def labels(intervals: List[Tuple[int, int]]) -> List[Tuple[str, bool]]:
        """Each interval's label and whether a program span gives it."""
        mids = [(a + b) // 2 for a, b in intervals]
        outer = _latest_covering(harness, mids)
        inner = [m or o for m, o in zip(_latest_covering(main, mids), _latest_covering(others, mids))]
        return [(f"{h or 'host'}/{i}" if i else (h or "host"), bool(i)) for h, i in zip(outer, inner)]

    gaps = _gaps(dev, w0, w1)
    cuts = sorted({t for iv in (*harness, *main, *others) for t in iv[:2]})
    pieces = []
    for a, b in gaps:
        for t in cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]:
            pieces.append((a, t))
            a = t
        pieces.append((a, b))
    by_label: Dict[str, float] = {}
    labelled: Dict[str, List[float]] = {}
    for (a, b), (label, inner) in zip(pieces, labels(pieces)):
        seconds = (b - a) / 1e9
        by_label[label] = by_label.get(label, 0.0) + seconds
        share = labelled.setdefault(label.split("/", 1)[0], [0.0, 0.0])
        share[0] += seconds if inner else 0.0
        share[1] += seconds
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = dict(zip(sorted(longest), labels(sorted(longest))))
    out = dict(base)
    out["idle_gaps"] = [[named[(a, b)][0], (b - a) / 1e9] for a, b in longest]
    out["idle_by_span"] = [[n, s] for n, s in sorted(by_label.items(), key=lambda kv: -kv[1])[:10]]
    out["labelled_s"] = dict(sorted(labelled.items()))
    return out


def program_intervals(
    events: List[Dict[str, Any]], tid_names: Dict[int, str], main_thread: str, shift_ns: int,
) -> Tuple[List[Interval], List[Interval]]:
    """The recorder's completed spans (``ts``/``dur`` in microseconds
    since the epoch) on the profiler's time base: the main thread's
    (its asyncio tasks included) and every other thread's."""
    main: List[Interval] = []
    others: List[Interval] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        a = e["ts"] * 1000 + shift_ns
        b = a + e["dur"] * 1000
        thread = tid_names.get(e["tid"], "")
        if thread == main_thread or thread.startswith(main_thread + ":task-"):
            main.append((a, b, e["bseq"], e["name"]))
        else:
            others.append((a, b, e["bseq"], f"{thread_base(thread)}:{e['name']}"))
    return main, others


class LabelledProfile(Profile):
    """``Profile`` that also reads the program's flight recorder over the
    window and labels the idle gaps by its spans."""

    def __init__(self, enabled: bool, kernels: Sequence[Any] = ()) -> None:
        super().__init__(enabled, kernels)
        self._mark: Any = None
        self._main_thread = ""
        self._program: Optional[Tuple[List[Dict[str, Any]], Dict[int, str], int]] = None

    def start(self) -> None:
        super().start()
        if self.enabled:
            from torchsnapshot_tpu_torch.telemetry.trace import get_recorder

            self._main_thread = threading.current_thread().name
            self._mark = get_recorder().mark()

    def stop(self) -> None:
        super().stop()
        if self._mark is not None:
            from torchsnapshot_tpu_torch.telemetry.trace import get_recorder

            recorder = get_recorder()
            events = recorder.events_since(self._mark)
            self._program = (events, recorder.tid_names(), recorder.dropped - self._mark.dropped)

    def reduce(self, spans: List[Tuple[str, int, int]]) -> Optional[Dict[str, Any]]:
        if self._prof is None or self._program is None:
            return super().reduce(spans)
        import torch

        events = self._prof.profiler.kineto_results.events()
        anchor = [e for e in events if e.name() == ANCHOR]
        if not anchor:
            return None
        w0 = anchor[0].start_ns()
        w1 = w0 + anchor[0].duration_ns()
        shift = w0 - self.anchor_host_ns
        dev = []
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
                continue
            a, b = max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1)
            if b > a:
                dev.append((a, b, e.name()))
        if not dev:
            return None
        program, tid_names, dropped = self._program
        main, others = program_intervals(program, tid_names, self._main_thread, shift)
        out = summarize_labelled(
            dev, w0, w1, [(n, a + shift, b + shift) for n, a, b in spans], main, others, self.kernels
        )
        out["program_spans"] = len(main) + len(others)
        out["program_spans_dropped"] = dropped
        return out


def install() -> None:
    """Make every later window of this process profile with
    ``LabelledProfile`` (run first in every rank, as ``run_cell``'s
    ``init``)."""
    from . import cell

    cell.Profile = LabelledProfile
