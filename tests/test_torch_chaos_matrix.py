"""The crash matrix in the port (``chaos/harness.py``): a save killed at
a declared crash point leaves a store where fsck finds nothing critical,
the newest committed step restores bit-identical, the CAS refcounts
reconcile, and the mirror resumes to durability.

Port of the JAX package's ``tests/test_chaos_matrix.py``, on torch states
on the CPU (``device="cpu"``): the 8-point smoke on the fullest
configuration (tiered + CAS) rides tier-1, each point firing and every
invariant holding; the full sweep over every declared point and the four
configurations stays slow-marked, as in the JAX package. Its two
``cdn-*`` points never fire in a manager save, in either package (the
harness drives no CDN publish), so the full sweep is red in both
(ROADMAP queue 3). A red cell's message carries the seed and fault-plan
line that replays it.
"""

import json

import pytest

from torchsnapshot_tpu_torch.chaos import declared_crashpoints
from torchsnapshot_tpu_torch.chaos.harness import (
    CONFIGS,
    FULL_CONFIG,
    CrashCaseResult,
    assert_matrix_green,
    run_crash_case,
    run_crash_matrix,
)
from torchsnapshot_tpu_torch.telemetry import names
from torchsnapshot_tpu_torch.tiered import reset_mirror

# The eight windows where a kill hurts most: data durable but the
# control plane absent, the torn index pair, the commit bracket, and the
# CAS pin, map and chunk states.
SMOKE_POINTS = (
    names.CRASH_TAKE_WRITES_DONE,
    names.CRASH_CHECKSUM_TABLE_WRITTEN,
    names.CRASH_CAS_CHUNK_WRITTEN,
    names.CRASH_CAS_MAP_WRITTEN,
    names.CRASH_PRE_COMMIT_MARKER,
    names.CRASH_COMMIT_MARKER,
    names.CRASH_INDEX_BACKUP_WRITTEN,
    names.CRASH_REFCOUNT_PINNED,
)


@pytest.fixture(autouse=True)
def _fresh_mirror():
    reset_mirror()
    yield
    reset_mirror()


def test_smoke_points_are_declared() -> None:
    from test_chaos_matrix import SMOKE_POINTS as JAX_SMOKE_POINTS

    assert set(SMOKE_POINTS) <= set(declared_crashpoints())
    assert len(SMOKE_POINTS) == 8 and SMOKE_POINTS == JAX_SMOKE_POINTS


@pytest.mark.parametrize("point", SMOKE_POINTS)
def test_crash_matrix_smoke(tmp_path, point) -> None:
    """The 8-point smoke on tiered + CAS: every point fires and every
    invariant holds."""
    result = run_crash_case(str(tmp_path), point, FULL_CONFIG, seed=0, device="cpu")
    assert_matrix_green([result])
    assert result.fired, f"{point} did not fire under {FULL_CONFIG.name}"


def test_red_cell_prints_replayable_fault_plan() -> None:
    """A failing cell's message carries the one JSON line that replays
    its fault schedule, and the JAX package's plan parser reads it."""
    from torchsnapshot_tpu.chaos import FaultPlan as JaxPlan

    bad = CrashCaseResult(
        point=names.CRASH_COMMIT_MARKER,
        config="tiered-cas",
        seed=17,
        fired=True,
        applicable=True,
        failures=["synthetic violation"],
    )
    with pytest.raises(AssertionError) as exc:
        assert_matrix_green([bad])
    message = str(exc.value)
    assert "replay:" in message
    line = next(l.split("replay:", 1)[1].strip() for l in message.splitlines() if "replay:" in l)
    plan = json.loads(line)
    assert plan["seed"] == 17
    assert plan["faults"][0]["match"] == names.CRASH_COMMIT_MARKER
    assert JaxPlan.from_json(line).to_json() == line


@pytest.mark.slow
def test_crash_matrix_full(tmp_path) -> None:
    """Every declared point x the four configurations: green, and every
    point fires in the fullest configuration."""
    results = run_crash_matrix(str(tmp_path), device="cpu")
    assert_matrix_green(results)
    assert len(results) == len(declared_crashpoints()) * len(CONFIGS)
    fired_in_full = {r.point for r in results if r.config == FULL_CONFIG.name and r.fired}
    missing = set(declared_crashpoints()) - fired_in_full
    assert not missing, f"declared crash points never fired under {FULL_CONFIG.name}: {sorted(missing)}"
