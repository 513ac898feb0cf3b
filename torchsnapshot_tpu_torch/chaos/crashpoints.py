"""Named kill points threaded through the take/commit/GC/mirror paths.

Counterpart of ``torchsnapshot_tpu/chaos/crashpoints.py``.
``crashpoint(names.CRASH_...)`` is the production no-op / test kill
switch: instrumented layers call it at the moments a real process kill
would be most damaging (chunk written but unpinned, backup index slot
written but not the primary, commit marker durable but unindexed, ...).
Unarmed, the call costs one global read and a branch. Armed — via
:func:`arm` (one point) or :func:`arm_engine` (a full fault plan whose
``crashpoint``-point specs drive it) — a matching hit raises
:class:`SimulatedCrash`.

``SimulatedCrash`` derives from ``BaseException`` on purpose: the
storage/telemetry layers wrap plenty of best-effort work in ``except
Exception`` blocks, and a simulated kill must not be absorbed by code a
real SIGKILL would never consult. (``finally`` blocks still run —
in-process simulation closes event loops a real kill would leak — so
the crash matrix asserts the *store's* invariants, which are exactly
the ones that must not depend on cleanup code running.)

The declared catalogue is the ``CRASH_*`` registry in
``telemetry/names.py`` (the JAX package's, copied);
:func:`declared_crashpoints` enumerates it, which is how the crash-matrix
harness turns "every declared point" into a sweep.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

CRASHPOINT = "crashpoint"  # the injection-point name in fault plans


class SimulatedCrash(BaseException):
    """An armed crash point fired — the in-process stand-in for a kill.

    BaseException, not Exception: best-effort recovery blocks must not
    absorb a simulated kill."""


_LOCK = threading.Lock()
_ENGINE = None  # the armed ChaosEngine (None = every crashpoint no-ops)
_HITS: Dict[str, int] = {}  # per-point hit counts while armed


def crashpoint(name: str) -> None:
    """Declare-and-maybe-die: no-op unless a chaos engine is armed and
    one of its ``crashpoint`` specs triggers on ``name``."""
    engine = _ENGINE
    if engine is None:
        return
    with _LOCK:
        _HITS[name] = _HITS.get(name, 0) + 1
    spec = engine.on_event(CRASHPOINT, name)
    if spec is not None:
        engine.raise_for(spec, name)


def arm_engine(engine) -> None:
    """Arm a full chaos engine; its ``crashpoint``-point specs decide
    which hits kill. Resets the hit counters."""
    global _ENGINE
    with _LOCK:
        _HITS.clear()
        _ENGINE = engine


def arm(name: str, at: int = 1, seed: int = 0):
    """Arm exactly one point: the ``at``-th hit of ``name`` raises.
    Returns the backing engine (its ``fired`` log pins replays)."""
    from .engine import ChaosEngine
    from .plan import crash_plan

    engine = ChaosEngine(crash_plan(name, seed=seed, after=at - 1))
    arm_engine(engine)
    return engine


def disarm() -> None:
    global _ENGINE
    with _LOCK:
        _ENGINE = None


def hits(name: Optional[str] = None):
    """Hit counts recorded since arming (all points, or one)."""
    with _LOCK:
        if name is not None:
            return _HITS.get(name, 0)
        return dict(_HITS)


def declared_crashpoints() -> List[str]:
    """Every declared crash-point id, from the ``CRASH_*`` registry in
    telemetry/names.py — the crash matrix's row set."""
    from ..telemetry import names

    return sorted(
        value
        for const, value in vars(names).items()
        if const.startswith("CRASH_") and isinstance(value, str)
    )
