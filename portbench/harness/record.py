"""What a run leaves for the per-layer readers, and helpers to read it.

A record is a plain dict (see ``cell.assemble``). Counters and histogram
sums are the registry's movement over the measured window, one dict per
rank, keyed by series (``name{label="value",...}``).
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, Iterable, List, Optional


def series_sum(per_rank: Dict[str, float], name: str, **labels: str) -> float:
    """Sum of every series of ``name`` whose labels include ``labels``."""
    total = 0.0
    for key, value in per_rank.items():
        base, _, rest = key.partition("{")
        if base != name:
            continue
        if all(f'{k}="{v}"' in rest for k, v in labels.items()):
            total += value
    return total


def counters(rec: Dict[str, Any], name: str, **labels: str) -> List[float]:
    """One number a rank: the counter's movement over the window."""
    return [series_sum(c, name, **labels) for c in rec["counters"]]


def hist_sums(rec: Dict[str, Any], name: str, **labels: str) -> List[float]:
    return [series_sum(h["sum"], name, **labels) for h in rec["histograms"]]


def hist_counts(rec: Dict[str, Any], name: str, **labels: str) -> List[float]:
    return [series_sum(h["count"], name, **labels) for h in rec["histograms"]]


def traces(rec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Each rank's trace summary; empty when the run was not traced or the
    profiler saw no device time on some rank."""
    t = rec.get("traces") or []
    return t if t and all(x is not None for x in t) else []


def mean(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    return statistics.fmean(values) if values else None


def ratio(num: float, den: float) -> Optional[float]:
    return num / den if den > 0 and num > 0 else None


def roofline_pct(rec: Dict[str, Any], kernel: str) -> Optional[float]:
    """A kernel table entry's calls x the bound of one call over its device
    seconds, in percent, mean over the ranks whose trace saw a call."""
    shares = []
    for t in traces(rec):
        k = t.get("kernels", {}).get(kernel)
        if k and k["calls"] and k["s"] > 0:
            shares.append(100.0 * k["calls"] * k["bound_s"] / k["s"])
    return mean(shares)
