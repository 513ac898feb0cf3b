"""Dual-sink trace annotations for the checkpoint pipeline.

Every annotation lands in two places at once:

- the **flight recorder** (telemetry/trace.py): always on, bounded ring;
- the **torch profiler timeline**: ``torch.profiler.record_function``
  places the same span next to the card's kernels and copies when a
  ``torch.profiler.profile`` session is active, making D2H/compute/I-O
  overlap directly visible. With no session active it costs one cheap
  dispatcher call.

NOTE: hold the recorder directly (``telemetry.trace.get_recorder().span``,
which tracks per asyncio task) for spans that cross an ``await``: the
profiler's range is thread-local begin/end, and an interleaved task on the
same thread would mis-nest it.
"""

from __future__ import annotations

from typing import Any, ContextManager

import torch

from ..telemetry.trace import get_recorder


class _DualAnnotation:
    """Flight-recorder span + ``torch.profiler.record_function``, one
    context manager (hand-rolled: it wraps every buffer's
    staging/write/read)."""

    __slots__ = ("_name", "_args", "_token", "_range")

    def __init__(self, name: str, args: dict) -> None:
        self._name = name
        self._args = args
        self._token = 0
        self._range = None

    def __enter__(self) -> None:
        self._token = get_recorder().begin(self._name, **self._args)
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self._range.__exit__(exc_type, exc, tb)
        finally:
            get_recorder().end(self._token)


def trace_annotation(name: str, **args: Any) -> ContextManager[None]:
    """A context manager placing ``name`` on the flight recorder AND the
    active torch profiler timeline (thread-local on the profiler side —
    safe on executor threads; see module note for coroutines)."""
    return _DualAnnotation(name, args)
