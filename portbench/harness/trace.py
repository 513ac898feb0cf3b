"""Host spans, and the reduction of a ``torch.profiler`` trace of the window.

The benchmark's own spans (``step``, ``drain`` (a step while a save
drains), ``save``, ``commit``, ``restore``, ``fingerprint``) are host-clock intervals in the profiler's time base; a
``portbench.window`` annotation anchors them. The reduction keeps what the
per-layer readers and the result's ``breakdown`` need: the device's busy
time (the union of its kernel, copy and set intervals), time by device
operation, idle gaps labelled by the innermost host span around them, and
the device time of the flash chunk kernel and of host<->device copies.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

ANCHOR = "portbench.window"
# The chunk kernel is flash_wgmma_kernel<Config, CAUSAL, FUSED> with FUSED
# false (csrc/flash_attention.cu); the fused forward has FUSED true.
FLASH_KERNEL = "flash_wgmma_kernel"


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


def is_flash_chunk(name: str) -> bool:
    if FLASH_KERNEL not in name:
        return False
    args = name.split(FLASH_KERNEL + "<", 1)[-1].split(">(", 1)[0]
    return args.replace(" ", "").endswith(",false>") or args.replace(" ", "").endswith(",false")


class Profile:
    """``torch.profiler`` over the window when ``enabled``; else inert."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
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
        return summarize(dev, w0, w1, [(n, a + shift, b + shift) for n, a, b in spans])


def summarize(
    dev: List[Tuple[int, int, str]], w0: int, w1: int, spans: List[Tuple[str, int, int]]
) -> Dict[str, Any]:
    """Reduce device intervals ``(start_ns, end_ns, name)`` inside the window
    ``[w0, w1)`` and host spans in the same time base."""
    by_name: Dict[str, float] = {}
    flash_s, flash_n, d2h_s, h2d_s = 0.0, 0, 0.0, 0.0
    for a, b, name in dev:
        s = (b - a) / 1e9
        by_name[name] = by_name.get(name, 0.0) + s
        if is_flash_chunk(name):
            flash_s += s
            flash_n += 1
        elif "DtoH" in name or "Device -> Pinned" in name or "Device -> Pageable" in name:
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
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "flash_chunk_s": flash_s,
        "flash_chunk_calls": flash_n,
        "d2h_s": d2h_s,
        "h2d_s": h2d_s,
        "device_ops": [[n[:160], s] for n, s in top],
        "idle_gaps": [[label(a, b), (b - a) / 1e9] for a, b in longest],
    }
