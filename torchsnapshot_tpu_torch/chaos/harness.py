"""The crash matrix: kill a take at every declared crash point, then
prove the store's global invariants.

Counterpart of ``torchsnapshot_tpu/chaos/harness.py``. The states are
torch tensors made from the seed with numpy, on the ``device=`` that
every entry point takes (the card by default; the CPU tests pass
``device="cpu"``).

Each case builds a fresh manager root (plain or tiered, legacy or CAS
layout), commits two clean steps, arms ONE declared crash point, and
runs a third save — which the armed point kills mid-flight (take,
commit window, index write, retention GC, chunk GC, or mirror enqueue,
wherever the point lives). The case then asserts what PR after PR has
claimed piecewise, together and mechanically:

1. a fresh manager loads (journals heal, CAS refcounts reconcile);
2. the newest *indexed* step restores bit-identical;
3. ``fsck --deep`` of that step finds nothing;
4. CAS roots: ``fsck --cas --deep`` over the whole store finds nothing
   critical (pre-GC strays are informational by design);
5. tiered roots: the mirror resumes and ``wait_durable`` completes;
6. a clean retake over the damaged root commits and restores.

Every case is driven by a seeded fault plan; a failing case's result
carries the ONE JSON line (:meth:`CrashCaseResult.replay`) that
reproduces the identical fault schedule.

The point set is :func:`~torchsnapshot_tpu_torch.chaos.declared_crashpoints`
— the ``CRASH_*`` registry in telemetry/names.py. Points that are
structurally unreachable in a configuration (CAS points under the
legacy layout, the mirror point on a plain root) are recorded as
inapplicable, and the full matrix asserts every point FIRES in at
least the tiered+CAS configuration, so a renamed or unthreaded point
can never silently leave the matrix.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .crashpoints import (
    SimulatedCrash,
    arm_engine,
    declared_crashpoints,
    disarm,
    hits,
)
from .engine import ChaosEngine
from .plan import crash_plan

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class MatrixConfig:
    """One store configuration a crash point is exercised under."""

    name: str
    tiered: bool
    cas: bool

    def applicable(self, point: str) -> bool:
        if point.startswith("cas-") or point in (
            "refcount-pinned",
            "gc-unpinned",
        ):
            return self.cas
        if point == "mirror-enqueued":
            return self.tiered
        return True


CONFIGS = (
    MatrixConfig("plain-legacy", tiered=False, cas=False),
    MatrixConfig("plain-cas", tiered=False, cas=True),
    MatrixConfig("tiered-legacy", tiered=True, cas=False),
    MatrixConfig("tiered-cas", tiered=True, cas=True),
)
FULL_CONFIG = CONFIGS[3]  # tiered+CAS: every point must fire here


@dataclasses.dataclass
class CrashCaseResult:
    point: str
    config: str
    seed: int
    fired: bool
    applicable: bool
    failures: List[str] = dataclasses.field(default_factory=list)
    latest_step: Optional[int] = None

    @property
    def ok(self) -> bool:
        return not self.failures

    @property
    def replay(self) -> str:
        """The deterministic reproduction line: seed + fault plan."""
        return crash_plan(self.point, seed=self.seed).to_json()

    def describe(self) -> str:
        status = "ok" if self.ok else "FAILED"
        fired = "fired" if self.fired else (
            "inapplicable" if not self.applicable else "NEVER FIRED"
        )
        out = f"[{status}] {self.config} × {self.point} ({fired})"
        if self.failures:
            out += "".join(f"\n    - {f}" for f in self.failures)
            out += f"\n    replay: {self.replay}"
        return out


def _state_for(seed: int, step: int, device: str) -> Dict[str, torch.Tensor]:
    """Deterministic per-step state: a dense leaf that changes every
    step and a static leaf (the CAS dedup case)."""
    rng = np.random.default_rng(seed)
    leaves = {
        "w": np.arange(4096, dtype=np.float32) + step,
        "b": rng.standard_normal(512).astype(np.float32),
        "step": np.asarray([step], dtype=np.int64),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in leaves.items()}


def _zeros_like(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(v) for k, v in state.items()}


def _copy(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in state.items()}


def run_crash_case(
    base_dir: str,
    point: str,
    config: MatrixConfig,
    seed: int = 0,
    durable_timeout_s: float = 120.0,
    device: Optional[str] = None,
) -> CrashCaseResult:
    """One matrix cell: fresh root, two clean saves, one save killed at
    ``point``, then the invariant battery. Never raises for store
    damage — every violation lands in ``result.failures``."""
    from .. import knobs
    from ..fsck import verify_cas_store, verify_snapshot
    from ..manager import CheckpointManager
    from ..models.transformer import resolve_device
    from ..snapshot import Snapshot
    from ..state_dict import TensorTreeState

    case_dir = os.path.join(
        base_dir, f"{config.name}-{point}".replace("/", "_")
    )
    shutil.rmtree(case_dir, ignore_errors=True)
    os.makedirs(case_dir, exist_ok=True)
    if config.tiered:
        fast = os.path.join(case_dir, "fast")
        durable = os.path.join(case_dir, "durable")
        root = f"tiered://{fast}|{durable}"
    else:
        root = os.path.join(case_dir, "root")

    result = CrashCaseResult(
        point=point,
        config=config.name,
        seed=seed,
        fired=False,
        applicable=config.applicable(point),
    )
    device = resolve_device(device)
    states = {step: _state_for(seed, step, device) for step in range(4)}
    cas_ctx = knobs.enable_cas() if config.cas else contextlib.nullcontext()
    with cas_ctx:
        mgr = CheckpointManager(root, keep_last_n=2)
        try:
            for step in (0, 1):
                mgr.save(step, {"m": TensorTreeState(_copy(states[step]))})
        except BaseException as e:  # noqa: BLE001 - setup must be clean
            result.failures.append(f"clean setup save failed: {e!r}")
            return result

        engine = ChaosEngine(crash_plan(point, seed=seed))
        arm_engine(engine)
        try:
            mgr.save(2, {"m": TensorTreeState(_copy(states[2]))})
        except SimulatedCrash:
            result.fired = True
        except BaseException as e:  # noqa: BLE001
            result.failures.append(
                f"killed save raised {e!r} instead of SimulatedCrash"
            )
        finally:
            disarm()
        if not result.fired:
            if result.applicable:
                result.failures.append(
                    f"crash point {point!r} never fired under "
                    f"{config.name} (hits recorded: {hits()})"
                )
            return result

        # -- invariants over the damaged store --------------------------
        try:
            mgr2 = CheckpointManager(root, keep_last_n=2)
        except BaseException as e:  # noqa: BLE001
            result.failures.append(f"manager reload failed: {e!r}")
            return result
        latest = mgr2.latest_step()
        result.latest_step = latest
        if latest not in (1, 2):
            result.failures.append(
                f"latest indexed step is {latest!r}, expected 1 or 2"
            )
            return result
        dest = {"m": TensorTreeState(_zeros_like(states[latest]))}
        try:
            restored = mgr2.restore_latest(dest)
        except BaseException as e:  # noqa: BLE001
            result.failures.append(f"restore of step {latest} failed: {e!r}")
            return result
        if restored != latest:
            result.failures.append(
                f"restore_latest returned {restored!r}, index said {latest}"
            )
        for key, want in states[latest].items():
            got = dest["m"].tree[key]
            if not torch.equal(got, want):
                result.failures.append(
                    f"step {latest} leaf {key!r} not bit-identical "
                    f"after restore"
                )
        if config.tiered:
            # Quiesce the mirror BEFORE the audits: a half-shipped
            # durable copy mid-flight is the mirror working, not store
            # damage, and the per-tier deep checks below must not race
            # it.
            try:
                mgr2.resume_mirrors()
                mgr2.wait_durable(latest, timeout=durable_timeout_s)
                # ... and the crashed take's own orphan job (a
                # committed-but-unindexed step still mirrors) — drain
                # everything so no job races the audits below.
                from ..tiered.mirror import get_mirror

                get_mirror().drain(timeout=durable_timeout_s)
            except BaseException as e:  # noqa: BLE001
                result.failures.append(
                    f"mirror resume/wait_durable({latest}) failed: {e!r}"
                )
        fsck = verify_snapshot(mgr2.step_path(latest), deep=True)
        for prob in fsck.problems:
            result.failures.append(
                f"fsck({latest}): {prob.kind} {prob.location}: {prob.detail}"
            )
        if config.cas:
            cas_report = verify_cas_store(root, deep=True)
            for prob in cas_report.problems:
                result.failures.append(
                    f"fsck --cas: {prob.kind} {prob.location}: "
                    f"{prob.detail}"
                )

        # -- the damaged root must accept a clean retake -----------------
        try:
            mgr2.save(3, {"m": TensorTreeState(_copy(states[3]))})
            dest3 = {"m": TensorTreeState(_zeros_like(states[3]))}
            Snapshot(mgr2.step_path(3)).restore(dest3)
            for key, want in states[3].items():
                if not torch.equal(dest3["m"].tree[key], want):
                    result.failures.append(
                        f"post-crash retake leaf {key!r} not bit-identical"
                    )
        except BaseException as e:  # noqa: BLE001
            result.failures.append(f"post-crash retake failed: {e!r}")
    return result


def run_crash_matrix(
    base_dir: str,
    points: Optional[Sequence[str]] = None,
    configs: Sequence[MatrixConfig] = CONFIGS,
    seed: int = 0,
    device: Optional[str] = None,
) -> List[CrashCaseResult]:
    """The sweep: every (declared point × configuration) cell. Returns
    every result; :func:`assert_matrix_green` turns violations into one
    failure message carrying each red cell's replay line."""
    results = []
    for config in configs:
        for point in points or declared_crashpoints():
            results.append(
                run_crash_case(base_dir, point, config, seed=seed, device=device)
            )
    return results


def assert_matrix_green(results: Sequence[CrashCaseResult]) -> None:
    bad = [r for r in results if not r.ok]
    if bad:
        raise AssertionError(
            f"crash matrix: {len(bad)} of {len(results)} cell(s) red\n"
            + "\n".join(r.describe() for r in bad)
        )
