"""Rule-mapped hill climbing: doctor verdict -> bounded knob move.

Copy of ``torchsnapshot_tpu/tuner/policy.py``, row for row.

Not ML — a policy table. Each doctor verdict names a *direction*
(docs/tuning.md has the same table in prose):

- ``budget-starved``: requests sat blocked on the host-memory budget —
  raise the budget fraction, then widen the staging pool.
- ``write-tail-stall``: one blob's write dominated the op — more I/O
  streams first, then O_DIRECT (a page-cache writeback storm is the
  classic single-blob tail), then smaller tail chunks so no single
  write can hold the drain hostage.
- ``storage-tier-slow``: the post-staging drain dominates — raise I/O
  concurrency, re-enable the zero-pack vectorized write if something
  turned it off, try O_DIRECT, then deepen the pool so staging can run
  further ahead.
- ``retry-storm``: the backend is throwing under load — *back off* the
  I/O concurrency.
- ``d2h-bound``: staging (D2H) is the wall — that's the physical
  ceiling; hold rather than thrash knobs that cannot move it.

With no verdict the policy explores: one round-robin parallelism move
per take (threads, streams, pool), until every candidate is saturated,
env-pinned, or cooling down after a revert. One move per take, one
step per move — the step sizes live on the tunables themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..telemetry import names
from . import tunables

# verdict id -> ordered candidate moves (tunable short name, direction).
# First applicable candidate wins; an empty list means "hold".
VERDICT_ACTIONS: Dict[str, List[Tuple[str, int]]] = {
    names.RULE_BUDGET_STARVED: [
        ("memory_budget_fraction", +1),
        ("staging_pool_slab_bytes", +1),
        ("staging_pool_slabs", +1),
    ],
    names.RULE_WRITE_TAIL_STALL: [
        ("io_concurrency", +1),
        ("fs_direct_io", +1),
        ("max_chunk_size_bytes", -1),
    ],
    names.RULE_STORAGE_TIER_SLOW: [
        ("io_concurrency", +1),
        ("write_vectorized", +1),
        ("fs_direct_io", +1),
        ("staging_pool_slabs", +1),
    ],
    names.RULE_RETRY_STORM: [
        ("io_concurrency", -1),
    ],
    names.RULE_D2H_BOUND: [],
}

# Verdicts are consulted in this priority order (most actionable first;
# d2h-bound last so a starved-AND-d2h take still gets its budget fix).
VERDICT_PRIORITY: List[str] = [
    names.RULE_BUDGET_STARVED,
    names.RULE_WRITE_TAIL_STALL,
    names.RULE_STORAGE_TIER_SLOW,
    names.RULE_RETRY_STORM,
    names.RULE_D2H_BOUND,
]

# A reverted move is not retried for this many subsequent decisions.
COOLDOWN_DECISIONS = 8


@dataclasses.dataclass
class Decision:
    """One tuning decision, fully replayable from the log record: what
    was done (``action``: adjust | hold | revert), to which tunable, in
    which direction, from/to which value, and why (the verdict or
    reason string that named the direction)."""

    action: str
    reason: str
    tunable: Optional[str] = None
    direction: int = 0
    from_value: Optional[float] = None
    to_value: Optional[float] = None
    verdicts: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def move_key(tunable: str, direction: int) -> str:
    return f"{tunable}:{'+' if direction > 0 else '-'}"


def _applicable(
    tunable: str,
    direction: int,
    vector: Dict[str, float],
    cooldowns: Dict[str, int],
    decision_count: int,
) -> bool:
    t = tunables.TUNABLES[tunable]
    if tunables.env_pinned(tunable):
        return False
    if t.saturated(vector[tunable], direction):
        return False
    rejected_at = cooldowns.get(move_key(tunable, direction))
    if (
        rejected_at is not None
        and decision_count - rejected_at < COOLDOWN_DECISIONS
    ):
        return False
    return True


def decide(
    verdict_ids: Sequence[str],
    vector: Dict[str, float],
    cooldowns: Dict[str, int],
    decision_count: int,
    explore_idx: int,
) -> Tuple[Decision, int]:
    """Pick the next move given this take's verdicts and the current
    effective vector. Returns the decision and the advanced exploration
    index (unchanged unless an exploration move was taken)."""
    seen = set(verdict_ids)
    for rule in VERDICT_PRIORITY:
        if rule not in seen:
            continue
        candidates = VERDICT_ACTIONS[rule]
        if not candidates:
            return (
                Decision(
                    action="hold",
                    reason=f"{rule}: at the D2H ceiling",
                    verdicts=sorted(seen),
                ),
                explore_idx,
            )
        for tunable, direction in candidates:
            if _applicable(
                tunable, direction, vector, cooldowns, decision_count
            ):
                t = tunables.TUNABLES[tunable]
                return (
                    Decision(
                        action="adjust",
                        reason=rule,
                        tunable=tunable,
                        direction=direction,
                        from_value=vector[tunable],
                        to_value=t.move(vector[tunable], direction),
                        verdicts=sorted(seen),
                    ),
                    explore_idx,
                )
        return (
            Decision(
                action="hold",
                reason=f"{rule}: every mapped move saturated/pinned/cooling",
                verdicts=sorted(seen),
            ),
            explore_idx,
        )
    # No mapped verdict: explore one parallelism lever per take.
    order = tunables.explore_order()
    for i in range(len(order)):
        tunable = order[(explore_idx + i) % len(order)]
        if _applicable(tunable, +1, vector, cooldowns, decision_count):
            t = tunables.TUNABLES[tunable]
            return (
                Decision(
                    action="adjust",
                    reason="explore",
                    tunable=tunable,
                    direction=+1,
                    from_value=vector[tunable],
                    to_value=t.move(vector[tunable], +1),
                    verdicts=sorted(seen),
                ),
                (explore_idx + i + 1) % len(order),
            )
    return (
        Decision(
            action="hold",
            reason="converged: no verdicts, exploration exhausted",
            verdicts=sorted(seen),
        ),
        explore_idx,
    )
