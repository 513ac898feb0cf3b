"""The closed-loop write-path autotuner.

Copy of ``torchsnapshot_tpu/tuner/autotuner.py``.

Each recurring checkpoint is one training example: after a manager step
commits, the tuner reads the step's just-emitted SnapshotReport, runs
the checkpoint doctor's report-scope rules over it, consults its own
rolling observation window, and decides ONE bounded move for the *next*
take (policy.py). Rank 0 decides; the decided vector is broadcast over
the ``dist_store`` coordinator and applied identically on every rank —
ranks never run mixed geometries (pinned by test).

Guard rails:

- **env always wins** — a hand-set knob is simply outside the tuner's
  reach (tunables.env_pinned);
- **bounded steps** — one move per take, one declared step factor per
  move, values clamped to declared bounds and the staging pool to the
  process memory budget;
- **revert-on-regression** — after an adjust, the next observation is
  checked against the rolling median ± MAD baseline with the exact
  trend math ``doctor --trend`` ships
  (``history.detect_trend_regressions``); a flagged ``take_s`` /
  ``mb_s`` restores the prior known-good vector and puts the offending
  move on cooldown;
- **crash-safe, replayable** — every decision lands in
  ``<root>/.tuner-state.json`` (state.py) before it takes effect.

Kill switch: ``TORCHSNAPSHOT_TPU_AUTOTUNE=0`` — the manager never
constructs an Autotuner (no state reads/writes, no broadcast, no
overrides; byte-identical to a build without the tuner).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional

from ..telemetry.history import TREND_WINDOW, detect_trend_regressions
from . import policy, state as tuner_state, tunables

logger: logging.Logger = logging.getLogger(__name__)

# The regression check watches the metrics a bad knob move actually
# damages: wall clock up, throughput down.
REGRESSION_METRICS = ("take_s", "mb_s")


def observation_from_report(
    step: int, report_dict: Dict[str, Any]
) -> Dict[str, Any]:
    """One rolling-window row from a take's SnapshotReport dict — the
    same metric keys ``history.summarize_report`` records, so the MAD
    trend math reads both identically."""
    from ..telemetry import safe_rate_mb_s

    phases = dict(report_dict.get("phases") or {})
    take_s = max((float(v) for v in phases.values()), default=0.0)
    return {
        "step": step,
        "kind": report_dict.get("kind"),
        "take_s": round(take_s, 3),
        "phases": phases,
        "bytes_moved": report_dict.get("bytes_moved", 0),
        "mb_s": round(
            safe_rate_mb_s(report_dict.get("bytes_moved", 0), take_s), 3
        ),
        "budget_wait_s": float(report_dict.get("budget_wait_s", 0.0)),
        "visible_s": report_dict.get("visible_s"),
        "tunables": dict(report_dict.get("tunables") or {}),
    }


class Autotuner:
    """One per CheckpointManager. ``tune_after_step`` is the only entry
    point; it is called on every rank after every committed step."""

    def __init__(self, root: str) -> None:
        self.root = root
        self._state: Optional[tuner_state.TunerState] = None

    # -- rank-0 decision --------------------------------------------------

    def _load_or_init(self) -> tuner_state.TunerState:
        if self._state is None:
            loaded = tuner_state.load_state(self.root)
            if loaded is None:
                vec = tunables.current_vector()
                loaded = tuner_state.TunerState(
                    vector=dict(vec), known_good=dict(vec)
                )
            self._state = loaded
        return self._state

    def _regressed(
        self, st: tuner_state.TunerState, row: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        """The new row against the rolling baseline of prior
        observations — the same median ± MAD math as ``doctor --trend``.
        Returns the first flagged evidence row (take_s/mb_s only), or
        None."""
        records = st.observations + [row]
        new_index = len(records) - 1
        for flagged in detect_trend_regressions(records, window=TREND_WINDOW):
            if (
                flagged["index"] == new_index
                and flagged["metric"] in REGRESSION_METRICS
            ):
                return flagged
        return None

    def _decide(
        self,
        step: int,
        report_dict: Optional[Dict[str, Any]],
        memory_budget_bytes: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Rank 0's half: observe, maybe revert, else consult the
        policy; clamp (bounds + pool-vs-budget); log the decision;
        return the vector to broadcast."""
        st = self._load_or_init()
        if not st.vector:
            st.vector = dict(tunables.current_vector())
            st.known_good = dict(st.vector)
        if report_dict is None:
            # Nothing observed (telemetry failed?): hold the vector.
            return dict(st.vector)
        row = observation_from_report(step, report_dict)

        last = st.decisions[-1] if st.decisions else None
        regression = None
        if last is not None and last["decision"]["action"] == "adjust":
            regression = self._regressed(st, row)

        if regression is not None:
            prev = last["decision"]
            decision = policy.Decision(
                action="revert",
                reason=(
                    f"regression on {regression['metric']} "
                    f"({regression['value']} vs baseline median "
                    f"{regression['baseline_median']}) after "
                    f"{prev['tunable']}"
                    f"{'+' if prev['direction'] > 0 else '-'}"
                ),
                tunable=prev["tunable"],
                direction=-prev["direction"],
                from_value=st.vector.get(prev["tunable"]),
                to_value=st.known_good.get(prev["tunable"]),
            )
            st.cooldowns[
                policy.move_key(prev["tunable"], prev["direction"])
            ] = st.decision_count
            st.vector = dict(st.known_good)
        else:
            # The current vector survived its first observation: it is
            # the new known-good (the revert target).
            st.known_good = dict(st.vector)
            verdict_ids = self._verdicts(report_dict)
            decision, st.explore_idx = policy.decide(
                verdict_ids,
                st.vector,
                st.cooldowns,
                st.decision_count,
                st.explore_idx,
            )
            if decision.action == "adjust":
                st.vector[decision.tunable] = decision.to_value

        # Clamp ONCE here, against rank 0's (symmetrically measured)
        # budget: the clamped vector is what gets logged, broadcast,
        # and applied verbatim everywhere.
        st.vector = tunables.clamp_vector(st.vector, memory_budget_bytes)
        st.record_observation(row)
        st.record_decision(
            {
                "step": step,
                "unix_ts": round(time.time(), 3),
                "decision": decision.to_dict(),
                "vector": dict(st.vector),
                "observed": {
                    "take_s": row["take_s"],
                    "mb_s": row["mb_s"],
                    "budget_wait_s": row["budget_wait_s"],
                },
            }
        )
        tuner_state.save_state(self.root, st)
        logger.info(
            "autotuner step %d: %s %s (%s)",
            step,
            decision.action,
            decision.tunable or "",
            decision.reason,
        )
        return dict(st.vector)

    @staticmethod
    def _verdicts(report_dict: Dict[str, Any]) -> list:
        from ..telemetry import doctor

        return [v.rule for v in doctor.diagnose_reports([report_dict])]

    # -- every-rank entry point -------------------------------------------

    def tune_after_step(
        self, step: int, report: Optional[Any], pg_wrapper: Any
    ) -> Optional[Dict[str, Any]]:
        """Decide (rank 0), broadcast, apply. ``report`` is rank 0's
        SnapshotReport for the step (ignored elsewhere). Every rank that
        committed the step must call this — the broadcast is symmetric
        whether or not rank 0 produced a decision (a failed decision
        broadcasts the unchanged vector). Returns the vector as applied
        on this rank."""
        from ..scheduler import get_process_memory_budget_bytes

        # Measured on EVERY rank (the local_world_size hostname
        # exchange inside is symmetric store traffic all ranks must
        # reach); only rank 0's reading is used — it clamps the decided
        # vector, so ranks apply one geometry even when their memory
        # readings differ.
        try:
            budget = get_process_memory_budget_bytes(pg_wrapper)
        except Exception as e:  # noqa: BLE001 - clamp input is best-effort
            logger.warning("autotuner: budget measurement failed: %r", e)
            budget = None
        decided: Optional[Dict[str, Any]] = None
        if pg_wrapper.get_rank() == 0:
            try:
                report_dict = (
                    report.to_dict()
                    if report is not None and hasattr(report, "to_dict")
                    else report
                )
                decided = self._decide(
                    step, report_dict, memory_budget_bytes=budget
                )
            except Exception as e:  # noqa: BLE001 - tuning never fails a save
                logger.warning("autotuner: decision failed: %r", e)
                decided = None
        if pg_wrapper.get_world_size() > 1:
            # Store-based broadcast (never a collective): safe on the
            # async-save commit thread, same transport every other
            # rank-0-decides path in the manager uses.
            decided = pg_wrapper.broadcast_object(decided)
        if decided is None:
            return None
        return tunables.apply_vector(decided)
