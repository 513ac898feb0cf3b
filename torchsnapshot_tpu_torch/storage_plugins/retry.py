"""Collective-progress retry strategy.

Counterpart of ``torchsnapshot_tpu/storage_plugins/retry.py``, used here by
the s3 and gcs plugins (``storage_plugins/s3.py``, ``gcs.py``) and the
tiered mirror (``tiered/mirror.py``).

Rather than a fixed retry count per operation, concurrent transfers share
a deadline that any completed transfer pushes out. While somebody makes
progress, stragglers keep retrying with jittered backoff; once nobody has
progressed for the window, everyone gives up.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Awaitable, Callable, Tuple, Type, TypeVar

from .. import telemetry
from ..telemetry import names as metric_names
from ..telemetry.trace import get_recorder as _trace_recorder

T = TypeVar("T")

DEFAULT_PROGRESS_WINDOW_SECONDS = 128.0
_BACKOFF_BASE_SECONDS = 1.0
_BACKOFF_MAX_SECONDS = 32.0


class RetriesExhausted(RuntimeError):
    pass


def decorrelated_backoff(
    prev_backoff_s: float,
    base_s: float = _BACKOFF_BASE_SECONDS,
    max_s: float = _BACKOFF_MAX_SECONDS,
    rng: "random.Random | None" = None,
) -> float:
    """Next sleep under decorrelated jitter: uniform over ``[base, 3 x
    previous sleep]``, capped. Drawing each range from the previous draw
    keeps processes that lost the backend at the same instant from
    retrying in lockstep. ``rng`` (default: the module's) pins a
    schedule."""
    r = rng if rng is not None else random
    return min(max_s, r.uniform(base_s, max(base_s, 3.0 * prev_backoff_s)))


class CollectiveProgressRetryStrategy:
    """Shared-deadline retry coordinator for one group of transfers."""

    def __init__(
        self,
        progress_window_seconds: float = DEFAULT_PROGRESS_WINDOW_SECONDS,
        scope: str = "",
        rng: "random.Random | None" = None,
    ) -> None:
        self.progress_window_seconds = progress_window_seconds
        # The backoff's generator: the module's unless a caller pins one
        # (two strategies' schedules compared in tests).
        self._rng = rng
        # The window starts at the first failure, not at construction: a
        # quiet period before the first operation must not count.
        self._deadline: "float | None" = None
        # Labels the registry counters ("s3", "gcs", "mirror"); the totals
        # are this instance's own.
        self.scope = scope
        self.attempts_total = 0
        self.backoff_s_total = 0.0
        self.exhausted_total = 0

    def record_progress(self) -> None:
        """Any completed operation pushes the collective deadline out."""
        self._deadline = time.monotonic() + self.progress_window_seconds

    @property
    def deadline_passed(self) -> bool:
        if self._deadline is None:
            return False
        return time.monotonic() > self._deadline

    async def run(
        self,
        op: Callable[[], Awaitable[T]],
        retriable_exceptions: Tuple[Type[BaseException], ...],
    ) -> T:
        """Run ``op``, retrying transient failures until the collective
        deadline lapses with no progress from any concurrent operation."""
        attempt = 0
        prev_backoff = _BACKOFF_BASE_SECONDS
        while True:
            try:
                result = await op()
            except retriable_exceptions as e:
                registry = telemetry.metrics()
                self.attempts_total += 1
                registry.counter_inc(metric_names.STORAGE_RETRY_ATTEMPTS_TOTAL, scope=self.scope)
                if self._deadline is None:
                    self._deadline = time.monotonic() + self.progress_window_seconds
                if self.deadline_passed:
                    self.exhausted_total += 1
                    registry.counter_inc(metric_names.STORAGE_RETRIES_EXHAUSTED_TOTAL, scope=self.scope)
                    raise RetriesExhausted(
                        f"No concurrent operation progressed within "
                        f"{self.progress_window_seconds:.0f}s; giving up "
                        f"after {attempt + 1} attempts"
                    ) from e
                backoff = decorrelated_backoff(prev_backoff, rng=self._rng)
                prev_backoff = backoff
                self.backoff_s_total += backoff
                registry.counter_inc(
                    metric_names.STORAGE_RETRY_BACKOFF_SECONDS_TOTAL, backoff, scope=self.scope
                )
                _trace_recorder().instant(
                    metric_names.INSTANT_STORAGE_RETRY,
                    scope=self.scope,
                    attempt=attempt + 1,
                    backoff_s=round(backoff, 3),
                )
                await asyncio.sleep(backoff)
                attempt += 1
            else:
                self.record_progress()
                return result
