"""Doctor-driven write-path autotuner.

Copy of ``torchsnapshot_tpu/tuner/``, with the same decision log
(``.tuner-state.json``): either package's tuner resumes from the other's
file. The telemetry stack *diagnoses* a slow checkpoint (per-phase
timings, budget-wait fraction, doctor verdicts, rolling history); this
package wires the diagnosis to the throttle. After every committed manager step the tuner adjusts a
declared set of tunables (tunables.py) for the next take via the
programmatic override layer in ``knobs.py`` — env vars always win,
every applied value is recorded in the SnapshotReport and the
``.tuner-state.json`` decision log, rank 0 decides and broadcasts so
ranks never run mixed geometries, and a move that regresses the take is
reverted with the same MAD trend math ``doctor --trend`` uses.

Kill switch: ``TORCHSNAPSHOT_TPU_AUTOTUNE=0``. See docs/tuning.md.
"""

from __future__ import annotations

from .autotuner import Autotuner, observation_from_report
from .policy import COOLDOWN_DECISIONS, Decision, VERDICT_ACTIONS, decide
from .state import (
    TUNER_STATE_BASENAME,
    TunerState,
    load_state,
    save_state,
    state_path_for,
)
from .tunables import (
    TUNABLES,
    Tunable,
    apply_vector,
    current_vector,
    env_pinned,
    reset_overrides,
)

__all__ = [
    "Autotuner",
    "COOLDOWN_DECISIONS",
    "Decision",
    "TUNABLES",
    "TUNER_STATE_BASENAME",
    "Tunable",
    "TunerState",
    "VERDICT_ACTIONS",
    "apply_vector",
    "current_vector",
    "decide",
    "env_pinned",
    "load_state",
    "observation_from_report",
    "reset_overrides",
    "save_state",
    "state_path_for",
]
