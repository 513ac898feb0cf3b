"""Host spans, and the reduction of a ``torch.profiler`` trace of the window.

The benchmark's own spans (``step``, ``drain`` (a step while a save
drains), ``save``, ``commit``, ``restore``, ``fingerprint``) are host-clock intervals in the profiler's time base; a
``portbench.window`` annotation anchors them. The reduction keeps what the
per-layer readers and the result's ``breakdown`` need: the device's busy
time (the union of its kernel, copy and set intervals), time by device
operation, idle gaps labelled by the innermost host span around them, the
device time of host<->device copies, and for each entry of the
architecture's kernel table (``harness/arch.py`` ``Kernel``) its device
seconds, its calls and the bound of one call.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

ANCHOR = "portbench.window"


class Spans:
    """Host spans on ``time.time_ns()``, kept in memory for the run."""

    def __init__(self) -> None:
        self.spans: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


class Profile:
    """``torch.profiler`` over the window when ``enabled``; else inert.
    ``kernels`` is the architecture's roofline table."""

    def __init__(self, enabled: bool, kernels: Sequence[Any] = ()) -> None:
        self.enabled = enabled
        self.kernels = tuple(kernels)
        self._prof: Any = None
        self._anchor: Any = None
        self.anchor_host_ns = 0

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._anchor = record_function(ANCHOR)
        self._anchor.__enter__()
        self.anchor_host_ns = time.time_ns()

    def stop(self) -> None:
        if self._prof is None:
            return
        self._anchor.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def reduce(self, spans: List[Tuple[str, int, int]]) -> Optional[Dict[str, Any]]:
        """The trace's summary, or None when no device time was recorded."""
        if self._prof is None:
            return None
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
        return summarize(dev, w0, w1, [(n, a + shift, b + shift) for n, a, b in spans], self.kernels)


def summarize(
    dev: List[Tuple[int, int, str]], w0: int, w1: int, spans: List[Tuple[str, int, int]],
    kernels: Sequence[Any] = (),
) -> Dict[str, Any]:
    """Reduce device intervals ``(start_ns, end_ns, name)`` inside the window
    ``[w0, w1)`` and host spans in the same time base; ``kernels`` is the
    roofline table whose entries' seconds and calls it sums."""
    by_name: Dict[str, float] = {}
    d2h_s, h2d_s = 0.0, 0.0
    table = {k.name: {"s": 0.0, "calls": 0, "bound_s": k.bound_s} for k in kernels}
    match = [(table[k.name], [re.compile(p) for p in k.time], re.compile(k.calls)) for k in kernels]
    hits: Dict[str, List[Tuple[Dict[str, Any], bool, bool]]] = {}  # by device op name
    for a, b, name in dev:
        s = (b - a) / 1e9
        by_name[name] = by_name.get(name, 0.0) + s
        if name not in hits:
            hits[name] = [
                (entry, any(p.search(name) for p in timed), bool(counted.search(name)))
                for entry, timed, counted in match
            ]
        for entry, timed, counted in hits[name]:
            if timed:
                entry["s"] += s
            if counted:
                entry["calls"] += 1
        if "DtoH" in name or "Device -> Pinned" in name or "Device -> Pageable" in name:
            d2h_s += s
        elif "HtoD" in name or "Pinned -> Device" in name or "Pageable -> Device" in name:
            h2d_s += s
    busy, gaps, covered = 0, [], w0
    for a, b, _ in sorted(dev):
        if a > covered:
            gaps.append((covered, a))
        busy += max(0, b - max(a, covered))
        covered = max(covered, b)
    if w1 > covered:
        gaps.append((covered, w1))

    def label(a: int, b: int) -> str:
        mid = (a + b) // 2
        inside = [(e - s, n) for n, s, e in spans if s <= mid < e]
        return min(inside)[1] if inside else "host"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out: Dict[str, Any] = {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "d2h_s": d2h_s,
        "h2d_s": h2d_s,
        "device_ops": [[n[:160], s] for n, s in top],
        "idle_gaps": [[label(a, b), (b - a) / 1e9] for a, b in longest],
        "kernels": table,
    }
    # Each entry also under its own keys, as flash_chunk_roofline reads it.
    for name, entry in table.items():
        out[f"{name}_s"], out[f"{name}_calls"] = entry["s"], entry["calls"]
    return out
