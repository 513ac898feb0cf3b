"""Named kill points threaded through the commit and GC paths.

``crashpoint(names.CRASH_...)`` marks a moment at which a real process
kill would be most damaging (the backup index slot written but not the
primary, a dropped step's commit marker deleted but not its blobs, ...).
The ``CRASH_*`` registry in ``telemetry/names.py`` declares them. Arming a
point needs the chaos engine and its fault plans
(``torchsnapshot_tpu/chaos/engine.py`` and ``plan.py``), which are not
ported yet (ROADMAP queue 1 step 9b): until then every point is a no-op,
and :func:`arm` and :func:`arm_engine` raise.
"""

from __future__ import annotations

_NOT_PORTED = (
    "arming a crash point needs the chaos engine and its fault plans, which "
    "torchsnapshot_tpu_torch does not have yet (ROADMAP queue 1 step 9b)"
)


def crashpoint(name: str) -> None:
    """Declare a kill point. A no-op: nothing can arm it yet."""


def arm_engine(engine) -> None:
    """Arm a full chaos engine. Not ported yet: raises."""
    raise NotImplementedError(_NOT_PORTED)


def arm(name: str, at: int = 1, seed: int = 0):
    """Arm one point: the ``at``-th hit of ``name`` raises. Not ported
    yet: raises."""
    raise NotImplementedError(_NOT_PORTED)
