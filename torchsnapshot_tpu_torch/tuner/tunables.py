"""The declared tunable set: what the autotuner is allowed to touch.

Copy of ``torchsnapshot_tpu/tuner/tunables.py``.

Each :class:`Tunable` names one knob from ``knobs.py``'s tunable
surface, its bounds, and its (multiplicative) step factor. The tuner
never writes env vars — it installs values through
``knobs.set_tuner_override``, which the override-aware accessors read
*below* any env var of the same name, so a hand-set knob is simply
outside the tuner's reach (``env_pinned``).

Bounds are guard rails, not performance claims: they keep a runaway
hill-climb from requesting absurd geometries (a 4 GiB chunk, 1024
staging threads) regardless of what the policy decides. The staging
pool is additionally clamped so ``slabs x slab_bytes`` never exceeds
the process memory budget it is accounted against.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

from .. import knobs

Value = Union[int, float]

MIB = 1024 * 1024


@dataclasses.dataclass(frozen=True)
class Tunable:
    """One adjustable knob: short name (the decision-log / report key),
    the env var the override layer keys off, bounds, and the step
    factor one hill-climb move multiplies (or divides) by."""

    name: str
    env: str
    lo: Value
    hi: Value
    step: float
    kind: str = "int"  # "int" | "float"

    def clamp(self, value: Value) -> Value:
        value = min(max(value, self.lo), self.hi)
        return int(round(value)) if self.kind == "int" else float(value)

    def move(self, value: Value, direction: int) -> Value:
        """One bounded step from ``value``: up multiplies by the step
        factor, down divides. int tunables always move by at least 1 so
        a small value (e.g. 2 threads) cannot get stuck rounding back
        onto itself."""
        if direction > 0:
            moved = value * self.step
            if self.kind == "int":
                moved = max(moved, value + 1)
        else:
            moved = value / self.step
            if self.kind == "int":
                moved = min(moved, value - 1)
        return self.clamp(moved)

    def saturated(self, value: Value, direction: int) -> bool:
        return self.clamp(value) == self.move(value, direction)


# Declaration order doubles as the exploration round-robin order for the
# first three entries (policy.EXPLORE_ACTIONS).
TUNABLES: Dict[str, Tunable] = {
    t.name: t
    for t in (
        Tunable("staging_threads", knobs._STAGING_THREADS_ENV, 1, 32, 2.0),
        Tunable(
            "io_concurrency", knobs._PER_RANK_IO_CONCURRENCY_ENV, 2, 128, 2.0
        ),
        Tunable(
            "staging_pool_slab_bytes",
            knobs._STAGING_POOL_SLAB_BYTES_ENV,
            16 * MIB,
            1024 * MIB,
            2.0,
        ),
        Tunable(
            "staging_pool_slabs", knobs._STAGING_POOL_SLABS_ENV, 2, 8, 2.0
        ),
        Tunable(
            "memory_budget_fraction",
            knobs._MEMORY_BUDGET_FRACTION_ENV,
            0.2,
            0.9,
            1.25,
            kind="float",
        ),
        Tunable(
            "max_chunk_size_bytes",
            knobs._MAX_CHUNK_SIZE_BYTES_ENV,
            32 * MIB,
            2048 * MIB,
            2.0,
        ),
        Tunable(
            "max_shard_size_bytes",
            knobs._MAX_SHARD_SIZE_BYTES_ENV,
            32 * MIB,
            2048 * MIB,
            2.0,
        ),
        Tunable(
            "slab_size_threshold_bytes",
            knobs._SLAB_SIZE_THRESHOLD_BYTES_ENV,
            4 * MIB,
            512 * MIB,
            2.0,
        ),
        # Binary write-path selectors (0/1): one "up" move enables, one
        # "down" move disables — the int-move floor of +-1 makes the
        # multiplicative step degenerate into a clean toggle, and
        # revert-on-regression gives a flip that hurt its normal undo.
        Tunable("write_vectorized", knobs._WRITE_VECTORIZED_ENV, 0, 1, 2.0),
        Tunable("fs_direct_io", knobs._FS_DIRECT_IO_ENV, 0, 1, 2.0),
        # Coordination topology (docs/scaling.md): the tree barrier's
        # branching factor, and the coordination-store shard count
        # (effective at the next store bootstrap — moving it mid-run is
        # safe but inert until a new process group forms).
        Tunable("barrier_fanout", knobs._BARRIER_FANOUT_ENV, 2, 64, 2.0),
        Tunable("store_shards", knobs._STORE_SHARDS_ENV, 1, 16, 2.0),
    )
}


def env_pinned(name: str) -> bool:
    """True when the operator hand-set this tunable's env var — the
    tuner must leave it alone (env always wins)."""
    import os

    return os.environ.get(TUNABLES[name].env) is not None


def current_vector() -> Dict[str, Value]:
    """The effective value of every tunable right now (env > override >
    default) — keys align with ``knobs.tunable_snapshot()``."""
    snap = knobs.tunable_snapshot()
    return {name: snap[name] for name in TUNABLES}


def clamp_vector(
    vector: Dict[str, Value],
    memory_budget_bytes: Optional[int] = None,
) -> Dict[str, Value]:
    """Clamp a vector to the declared bounds and — when a budget is
    given — shrink the staging pool so ``slabs x slab_bytes`` fits
    inside it (slab bytes first, then the slab count, so a tiny budget
    can't be over-committed by the slab-bytes lower bound). The one
    clamp both the decision path and direct apply callers share."""
    vector = {
        name: TUNABLES[name].clamp(vector[name])
        for name in TUNABLES
        if name in vector
    }
    if memory_budget_bytes is not None and memory_budget_bytes > 0:
        slabs = int(vector.get("staging_pool_slabs", 0) or 0)
        slab_bytes = int(vector.get("staging_pool_slab_bytes", 0) or 0)
        if slabs and slab_bytes and slabs * slab_bytes > memory_budget_bytes:
            slab_bytes = int(
                TUNABLES["staging_pool_slab_bytes"].clamp(
                    memory_budget_bytes // slabs
                )
            )
            if slabs * slab_bytes > memory_budget_bytes:
                slabs = int(
                    TUNABLES["staging_pool_slabs"].clamp(
                        memory_budget_bytes // slab_bytes
                    )
                )
            vector["staging_pool_slab_bytes"] = slab_bytes
            vector["staging_pool_slabs"] = slabs
    return vector


def apply_vector(
    vector: Dict[str, Value],
    memory_budget_bytes: Optional[int] = None,
) -> Dict[str, Value]:
    """Install a decided vector through the programmatic override layer.
    Env-pinned tunables are skipped (their env value stays effective);
    everything else goes through :func:`clamp_vector`. The autotuner
    broadcasts an ALREADY-clamped vector and applies it without a
    budget here — a per-rank clamp against per-rank memory readings
    would diverge geometries across ranks. Returns the vector as
    applied (the effective values, env-pinned entries included)."""
    vector = clamp_vector(vector, memory_budget_bytes)
    for name, value in vector.items():
        if env_pinned(name):
            continue
        knobs.set_tuner_override(TUNABLES[name].env, value)
    return current_vector()


def reset_overrides() -> None:
    """Drop this process's programmatic overrides for the declared set
    (kill switch / teardown)."""
    for t in TUNABLES.values():
        knobs.clear_tuner_override(t.env)


def explore_order() -> List[str]:
    """Tunables the no-verdict exploration round-robin cycles through:
    the parallelism levers (threads, I/O streams, pool size) — the ones
    that trade host resources for pipeline overlap."""
    return ["staging_threads", "io_concurrency", "staging_pool_slab_bytes"]
