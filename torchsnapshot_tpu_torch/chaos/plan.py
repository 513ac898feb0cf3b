"""Declarative, seeded fault plans: the one description of an adversary.

Counterpart of ``torchsnapshot_tpu/chaos/plan.py``, with the same JSON
line, so one plan replays the same fired schedule under either package's
engine. A :class:`FaultPlan` is a seed plus an ordered list of :class:`FaultSpec`
entries; it serializes to ONE JSON line (``to_json``/``from_json``) so a
red test run can print the exact adversary needed to replay it. The
engine (chaos/engine.py) evaluates the plan against a stream of
*injection events* — ``(point, key)`` pairs the instrumented layers
emit — and, because the per-spec RNGs are seeded from ``seed`` and
advance only on matching events, the same plan over the same event
stream always produces the same fault schedule.

Injection points (the ``point`` of a spec):

- ``storage-write`` / ``storage-read`` / ``storage-delete`` — a wrapped
  :class:`~torchsnapshot_tpu_torch.io_types.StoragePlugin` op; ``key`` is the
  blob path.
- ``store-set`` / ``store-get`` / ``store-add`` / ``store-delete`` — a
  wrapped coordination :class:`~torchsnapshot_tpu_torch.dist_store.Store` op;
  ``key`` is the store key.
- ``wire-send`` / ``wire-recv`` — one length-prefixed frame crossing
  the socket framing of the TCP store or the peer tier
  (``dist_store.send_frame`` / ``recv_frame``); ``key`` is the frame
  length, trace header included.
- ``crashpoint`` — a named kill point threaded through the take/commit/
  GC/mirror paths; ``key`` is the declared ``CRASH_*`` id
  (telemetry/names.py).

Modes (what happens when a spec triggers):

- ``fail`` — raise ``OSError(exc_msg)`` (storage), ``ConnectionError``
  (store/wire).
- ``delay`` — sleep ``delay_s``, then proceed normally.
- ``corrupt`` — size-preserving bit damage: flip one byte of the
  payload (written bytes, read buffer, or wire frame) — only a digest
  can catch it.
- ``torn`` — storage-write only: persist a strict prefix of the bytes,
  then raise (the kill-mid-write shape).
- ``drop`` — storage-write: report success, write nothing (a lost
  write); store-set: swallow the set.
- ``crash`` — raise :class:`~torchsnapshot_tpu_torch.chaos.SimulatedCrash`
  (a ``BaseException``: best-effort ``except Exception`` recovery
  blocks cannot absorb it, matching a real kill).

Triggering: a spec considers only events whose ``point`` matches and
whose ``key`` contains ``match`` (empty = every key). Of those, the
first ``after`` are skipped, then each fires with probability ``prob``
(spec-seeded RNG; 1.0 = always) until ``times`` triggers have fired
(None = unbounded).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Sequence

MODES = ("fail", "delay", "corrupt", "torn", "drop", "crash")


@dataclasses.dataclass
class FaultSpec:
    """One fault: where (``point``/``match``), what (``mode``), when
    (``after``/``times``/``prob``). ``predicate`` is a programmatic
    escape hatch (a ``key -> bool`` callable consulted instead of
    ``match``) for in-process harnesses; it does not serialize —
    plans meant for replay use ``match``/``after``/``prob`` only."""

    point: str
    mode: str = "fail"
    match: str = ""
    after: int = 0
    times: Optional[int] = 1
    prob: float = 1.0
    delay_s: float = 0.0
    exc_msg: str = "chaos: injected fault"
    predicate: Optional[Callable[[str], bool]] = dataclasses.field(
        default=None, compare=False
    )

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(
                f"unknown fault mode {self.mode!r} (one of {MODES})"
            )

    def matches(self, key: str) -> bool:
        if self.predicate is not None:
            return bool(self.predicate(key))
        return self.match in key

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"point": self.point, "mode": self.mode}
        if self.match:
            out["match"] = self.match
        if self.after:
            out["after"] = self.after
        if self.times != 1:
            out["times"] = self.times
        if self.prob != 1.0:
            out["prob"] = self.prob
        if self.delay_s:
            out["delay_s"] = self.delay_s
        if self.exc_msg != "chaos: injected fault":
            out["exc_msg"] = self.exc_msg
        return out

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "FaultSpec":
        known = {f.name for f in dataclasses.fields(cls) if f.name != "predicate"}
        return cls(**{k: v for k, v in data.items() if k in known})


@dataclasses.dataclass
class FaultPlan:
    """A seed plus an ordered fault list; the unit of replay."""

    seed: int = 0
    faults: List[FaultSpec] = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        """ONE compact line — what a failing harness prints so the red
        run replays from a copy-paste."""
        return json.dumps(
            {
                "seed": self.seed,
                "faults": [f.to_dict() for f in self.faults],
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, line: str) -> "FaultPlan":
        data = json.loads(line)
        return cls(
            seed=int(data.get("seed", 0)),
            faults=[FaultSpec.from_dict(f) for f in data.get("faults", [])],
        )

    @classmethod
    def single(cls, seed: int = 0, **spec_kwargs: Any) -> "FaultPlan":
        return cls(seed=seed, faults=[FaultSpec(**spec_kwargs)])


def crash_plan(
    point_name: str, seed: int = 0, after: int = 0
) -> FaultPlan:
    """The crash-matrix adversary: kill at the ``after+1``-th hit of one
    declared crash point."""
    return FaultPlan(
        seed=seed,
        faults=[
            FaultSpec(
                point="crashpoint",
                mode="crash",
                match=point_name,
                after=after,
            )
        ],
    )


def seeded_failure_plan(
    seed: int,
    point: str,
    fail_at: int,
    mode: str = "fail",
    exc_msg: str = "chaos: injected fault",
    ops: Sequence[str] = (),
    predicate: Optional[Callable[[str], bool]] = None,
    delay_s: float = 0.0,
) -> FaultPlan:
    """The crash-consistency sweep shape: fail every matching op of
    ``point`` (and of every extra point in ``ops``) after skipping the
    first ``fail_at``. Each point carries its OWN skip counter — a
    multi-point plan is N independent adversaries, not one shared "Nth
    storage op overall" counter; callers wanting a shared count across
    op kinds pass a counting ``predicate`` instead."""
    points = [point, *[p for p in ops if p != point]]
    return FaultPlan(
        seed=seed,
        faults=[
            FaultSpec(
                point=p,
                mode=mode,
                after=fail_at,
                times=None,
                exc_msg=exc_msg,
                predicate=predicate,
                delay_s=delay_s,
            )
            for p in points
        ],
    )
