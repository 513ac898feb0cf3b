"""Crash-safe, replayable tuner state: ``<root>/.tuner-state.json``.

Copy of ``torchsnapshot_tpu/tuner/state.py``, in the same schema.

Rank 0 rewrites the whole document atomically after every decision
(``telemetry.sink.atomic_write_text`` — the same primitive behind every
other rewritten telemetry artifact), so a crash mid-decision leaves the
previous complete state and a restarted run resumes from its last
applied vector instead of re-climbing from the defaults.

The document is an audit log first: every decision record carries the
step, the verdicts that named the direction, the move (tunable,
direction, from -> to), and the observed metrics — enough to replay the
whole trajectory by hand (docs/tuning.md "Replaying a decision log")
and enough for the checkpoint doctor's ``tuner-thrashing`` rule to cite
concrete oscillating entries.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, List, Optional

logger: logging.Logger = logging.getLogger(__name__)

TUNER_STATE_BASENAME = ".tuner-state.json"
SCHEMA_VERSION = 1

# Bounds: the newest N decision / observation records are kept. The
# observation window feeds the MAD trend math; 64 decisions is weeks of
# checkpoint cadence and keeps the file trivially small.
MAX_DECISIONS = 64
MAX_OBSERVATIONS = 64


@dataclasses.dataclass
class TunerState:
    """The autotuner's whole memory. ``vector`` is the currently-applied
    tunable vector; ``known_good`` the last vector that survived a take
    without a trend regression (the revert target); ``cooldowns`` maps
    ``tunable:+|-`` move keys to the decision index they were rejected
    at; ``observations`` the rolling per-step metric rows the MAD-based
    regression check runs over."""

    vector: Dict[str, float] = dataclasses.field(default_factory=dict)
    known_good: Dict[str, float] = dataclasses.field(default_factory=dict)
    decisions: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    observations: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list
    )
    cooldowns: Dict[str, int] = dataclasses.field(default_factory=dict)
    decision_count: int = 0
    explore_idx: int = 0
    schema_version: int = SCHEMA_VERSION

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "TunerState":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    def record_decision(self, record: Dict[str, Any]) -> None:
        self.decisions.append(record)
        self.decision_count += 1
        if len(self.decisions) > MAX_DECISIONS:
            self.decisions = self.decisions[-MAX_DECISIONS:]

    def record_observation(self, row: Dict[str, Any]) -> None:
        self.observations.append(row)
        if len(self.observations) > MAX_OBSERVATIONS:
            self.observations = self.observations[-MAX_OBSERVATIONS:]


def state_path_for(root: str) -> Optional[str]:
    """Where a manager root's tuner state lives, or None for
    object-store roots (like the step history, the decision log is a
    local operator aid — the tuner still runs, it just cannot persist
    its memory across restarts)."""
    from ..telemetry.sink import local_fs_root

    local = local_fs_root(root)
    if local is None:
        return None
    return os.path.join(local, TUNER_STATE_BASENAME)


def load_state(root: str) -> Optional[TunerState]:
    """The persisted state, or None when absent/non-local/corrupt (a
    corrupt file logs and restarts the climb — tuning must never fail
    a save)."""
    path = state_path_for(root)
    if path is None or not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            return TunerState.from_dict(json.load(f))
    except (OSError, ValueError, TypeError) as e:
        logger.warning("tuner: corrupt state at %r (%r); restarting", path, e)
        return None


def save_state(root: str, state: TunerState) -> Optional[str]:
    """Atomic rewrite; best-effort (returns the path, or None when the
    root is non-local or the write failed)."""
    path = state_path_for(root)
    if path is None:
        return None
    try:
        from ..telemetry.sink import atomic_write_text

        atomic_write_text(
            path, json.dumps(state.to_dict(), sort_keys=True, indent=1)
        )
        return path
    except Exception as e:  # noqa: BLE001 - state persist must not fail a save
        logger.warning("tuner: could not persist state to %r: %r", path, e)
        return None
