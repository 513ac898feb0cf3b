"""The port's scale-model storms (``scalemodel/harness.py``): the ports
of ``tests/test_scalemodel.py``'s 14 cases, at its world sizes.

Fast lane: a storm of up to 256 simulated ranks (a clean run and injected
rank death) over the port's own ``dist_store`` / ``pg_wrapper`` /
``fanout`` code, the batching and request-count pins through the
counting store, and the ``coordination-bound`` doctor rule and report
plumbing. Slow lane (marked slow, as in the JAX file): the 1000-rank
sweep in which the tree barrier's hot-key fan-in stays O(fanout) where
the linear barrier's concentrates O(world * polls) on its leader keys.

With hundreds of simulated ranks in one process the thread scheduler,
not the protocol, dominates wall time: these tests pin structural
quantities (request counts, per-key fan-in, completion, abort latency
bounds).
"""

import time

import pytest

from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.dist_store import InProcessStore, lookup_endpoints, publish_endpoint
from torchsnapshot_tpu_torch.scalemodel import (
    CountingStore,
    PerKeyStore,
    StormConfig,
    StormResult,
    run_storm,
)
from torchsnapshot_tpu_torch.telemetry import names
from torchsnapshot_tpu_torch.telemetry.doctor import diagnose_reports
from torchsnapshot_tpu_torch.telemetry.report import build_report


# ---------------------------------------------------------------------------
# Storm smoke (fast lane)
# ---------------------------------------------------------------------------


def test_storm_smoke_256_ranks():
    """256 simulated ranks drive save + restore + endpoint storms to
    completion on the shipped defaults: every rank's exchanged bytes
    verify, nobody errors, nobody hangs."""
    result = run_storm(
        StormConfig(world_size=256, steps=1, timeout_s=120.0)
    )
    assert result.errors == {}
    assert result.hung_ranks == 0
    assert result.verified_ranks == 256
    # The exchange and barrier keys are transient: per-key touches must
    # exist (the storm really ran) and the coordination counters must
    # have observed it.
    assert result.store_requests > 0
    assert result.max_s["barrier_s"] > 0
    assert result.max_s["exchange_s"] > 0


def test_storm_rank_death_aborts_survivors_fast():
    """Injected rank death mid-round: every survivor abandons via the
    poisoned round barrier (BarrierError/FanoutError) well inside the
    round timeout — the production fail-fast contract at a world size
    the 2-proc sweep cannot exercise."""
    t0 = time.monotonic()
    result = run_storm(
        StormConfig(
            world_size=96,
            steps=1,
            kill_ranks=frozenset({7, 41}),
            timeout_s=60.0,
        )
    )
    elapsed = time.monotonic() - t0
    assert result.survivors_aborted_cleanly()
    # Victims recorded their injected fault; survivors their aborts.
    assert len(result.errors) == 96
    assert "SimulatedPreemption" in result.errors[7]
    # Fail-fast, not timeout-bound: the whole storm (including victim
    # detection on every survivor) must resolve far below the 60 s
    # round timeout.
    assert elapsed < 30.0


def test_storm_linear_barrier_and_per_key_baseline_complete():
    """The baseline axes (LinearBarrier, per-key store ops, legacy
    fixed polling) still complete correctly at a modest world: a
    comparison is about their cost, not their correctness."""
    result = run_storm(
        StormConfig(
            world_size=32,
            steps=1,
            barrier="linear",
            batched=False,
            legacy_poll=True,
            timeout_s=60.0,
        )
    )
    assert result.errors == {}
    assert result.verified_ranks == 32


def test_batched_storm_issues_fewer_store_requests():
    """The batching pin: the same storm over the same store issues
    materially fewer wire requests with multi-key ops than with the
    per-key baseline (each multi_* is ONE request; per-key degrades to
    one per key)."""
    batched = run_storm(
        StormConfig(world_size=48, steps=2, timeout_s=60.0)
    )
    per_key = run_storm(
        StormConfig(world_size=48, steps=2, batched=False, timeout_s=60.0)
    )
    assert batched.errors == {} and per_key.errors == {}
    assert batched.store_requests < per_key.store_requests


def test_sharded_store_storm_completes():
    result = run_storm(
        StormConfig(world_size=48, steps=1, store_shards=4, timeout_s=60.0)
    )
    assert result.errors == {}
    assert result.verified_ranks == 48


def test_tree_hot_key_fanin_bounded_vs_linear():
    """The structural claim at fast-lane scale: the tree barrier's
    hottest data key sees O(fanout) touches while the linear barrier
    concentrates O(world·polls) on its leader keys."""
    common = dict(
        steps=3,
        warmup_steps=1,
        save_collectives=False,
        restore_storm=False,
        endpoint_round=False,
        timeout_s=60.0,
    )
    tree = run_storm(StormConfig(world_size=128, **common))
    linear = run_storm(
        StormConfig(world_size=128, barrier="linear", **common)
    )
    assert tree.errors == {} and linear.errors == {}
    assert tree.hot_data_key_touches < linear.hot_data_key_touches
    # Fanout 16, 3 timed steps, 2 phases: the root counter is touched
    # ~fanout times per phase plus a few polls — two orders of
    # magnitude under 128 ranks' worth.
    assert tree.hot_data_key_touches < 128 * 3


# ---------------------------------------------------------------------------
# Endpoint batching pin (satellite: one round trip, not world lookups)
# ---------------------------------------------------------------------------


def test_endpoint_resolution_is_one_round_trip():
    inner = InProcessStore()
    for rank in range(64):
        publish_endpoint(inner, "svc", rank, "host", 9000 + rank)
    store = CountingStore(inner)
    endpoints = lookup_endpoints(store, "svc", range(64))
    assert len(endpoints) == 64
    assert endpoints[5] == ("host", 9005)
    assert store.counts == {"multi_get": 1}


def test_endpoint_resolution_per_key_baseline_pays_world_requests():
    # Counting at the wire, per-key adapter above it: the baseline's
    # one logical resolve fans into world sequential requests.
    inner = InProcessStore()
    for rank in range(64):
        publish_endpoint(inner, "svc", rank, "host", 9000 + rank)
    counting = CountingStore(inner)
    endpoints = lookup_endpoints(PerKeyStore(counting), "svc", range(64))
    assert len(endpoints) == 64
    assert counting.total_requests == 64


# ---------------------------------------------------------------------------
# Report / doctor plumbing
# ---------------------------------------------------------------------------


def _coord_report(barrier_s=2.0, store_s=1.0, exchange_s=0.0, wall_s=1.0):
    report = build_report(
        kind="restore",
        path="/tmp/snap",
        rank=0,
        world_size=256,
        pipeline={"phases": {"loading": wall_s}},
        counter_deltas={
            f"{names.COORD_BARRIER_WAIT_SECONDS_TOTAL}"
            '{impl="tree",phase="arrive"}': barrier_s,
            f"{names.COORD_STORE_SECONDS_TOTAL}" '{op="multi_get"}': store_s,
            f"{names.COORD_STORE_REQUESTS_TOTAL}"
            '{op="multi_get"}': 1000.0,
            names.COORD_EXCHANGE_SECONDS_TOTAL: exchange_s,
        },
    ).to_dict()
    return report


def test_report_coordination_field_from_counter_deltas():
    report = _coord_report()
    assert report["coordination"]["barrier_wait_s"] == pytest.approx(2.0)
    assert report["coordination"]["store_s"] == pytest.approx(1.0)
    assert report["coordination"]["store_ops"] == pytest.approx(1000.0)
    # No coordination traffic at all -> schema-light None.
    empty = build_report(
        kind="take",
        path="/tmp/snap",
        rank=0,
        world_size=1,
        pipeline={},
        counter_deltas={},
    )
    assert empty.coordination is None


def test_coordination_bound_rule_fires_and_cites_split():
    verdicts = diagnose_reports(
        [_coord_report(barrier_s=2.0, store_s=1.0, wall_s=1.0)]
    )
    hits = [v for v in verdicts if v.rule == names.RULE_COORDINATION_BOUND]
    assert len(hits) == 1
    ev = hits[0].evidence
    assert ev["barrier_wait_s"] == pytest.approx(2.0)
    assert ev["coordination_fraction"] > 0.5
    assert names.SPAN_BARRIER_ARRIVE in ev["spans"]


def test_coordination_bound_rule_quiet_when_coordination_small():
    # 2% of the wall: healthy.
    verdicts = diagnose_reports(
        [_coord_report(barrier_s=0.1, store_s=0.1, wall_s=10.0)]
    )
    assert not any(
        v.rule == names.RULE_COORDINATION_BOUND for v in verdicts
    )
    # Sub-floor absolute coordination never flags (ms-scale local ops).
    verdicts = diagnose_reports(
        [_coord_report(barrier_s=0.01, store_s=0.01, wall_s=0.01)]
    )
    assert not any(
        v.rule == names.RULE_COORDINATION_BOUND for v in verdicts
    )


def test_history_summary_carries_coordination_seconds():
    from torchsnapshot_tpu_torch.telemetry.history import summarize_report
    from torchsnapshot_tpu_torch.telemetry.report import SnapshotReport

    report = SnapshotReport.from_dict(_coord_report())
    summary = summarize_report(report, step=3)
    assert summary["coordination_s"] == pytest.approx(3.0)
    no_coord = SnapshotReport(kind="take", path="/tmp/x")
    assert summarize_report(no_coord)["coordination_s"] is None


# ---------------------------------------------------------------------------
# 1000-rank sweep (slow lane)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_thousand_rank_sweep_tree_sublinear_vs_linear():
    """The acceptance sweep: barrier-only storms at world 64
    and 1000. The tree barrier completes at 1000 simulated ranks with
    zero errors, and its coordination cost grows SUB-linearly — the
    hot-key fan-in (the serialized per-key work a real store pays; wall
    time at 1000 threads in one process measures the host scheduler,
    see module docstring) stays O(fanout) while the world grew 15.6x —
    where the linear barrier's leader keys absorb orders of magnitude
    more."""
    common = dict(
        steps=3,
        warmup_steps=1,
        save_collectives=False,
        restore_storm=False,
        endpoint_round=False,
        timeout_s=300.0,
    )
    tree_64 = run_storm(StormConfig(world_size=64, **common))
    tree_1000 = run_storm(StormConfig(world_size=1000, **common))
    linear_1000 = run_storm(
        StormConfig(world_size=1000, barrier="linear", **common)
    )
    for result in (tree_64, tree_1000, linear_1000):
        assert result.errors == {}
        assert result.hung_ranks == 0
    # Sub-linear: the world grew 15.6x; the tree's hottest data key
    # must not grow anywhere near that (it is bounded by the fanout
    # plus poll jitter — measured ~2x).
    assert (
        tree_1000.hot_data_key_touches
        < tree_64.hot_data_key_touches * 8
    )
    # ...while the linear barrier's leader keys concentrate orders of
    # magnitude more serialized work at the same world.
    assert (
        linear_1000.hot_data_key_touches
        > tree_1000.hot_data_key_touches * 20
    )


def test_storm_result_shape():
    """The result's fields are its contract: pin them."""
    result = run_storm(StormConfig(world_size=4, steps=1, timeout_s=30.0))
    assert isinstance(result, StormResult)
    for key in ("collective_s", "barrier_s", "exchange_s", "endpoint_s"):
        assert key in result.max_s and key in result.mean_s
    assert result.coordination_s >= 0
    assert result.counters  # coordination_* deltas observed
    assert any(
        k.startswith("coordination_barrier_wait_seconds_total")
        for k in result.counters
    )
