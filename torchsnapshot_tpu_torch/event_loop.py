"""Tiny asyncio helpers.

The snapshot paths create a fresh event loop per operation (reference:
snapshot.py:206) so they work both in plain scripts and inside frameworks
that already run a loop on another thread.
"""

from __future__ import annotations

import asyncio
from typing import Any, Coroutine, TypeVar

T = TypeVar("T")


def run_in_fresh_event_loop(coro: Coroutine[Any, Any, T]) -> T:
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()
