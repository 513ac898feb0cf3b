"""The port's CDN subscriber storm (``scalemodel/cdn_storm.py``):
convergence, read amplification of 1.0, the rolling update's dedup ratio
and warmup left out of the staleness figures. The ports of
``tests/test_cdn_storm.py``'s 4 storm cases; its staleness doctor rule
cases are in ``tests/test_torch_doctor.py``."""

import os

from torchsnapshot_tpu_torch.scalemodel import CdnStormConfig, build_step_chunks, run_cdn_storm
from torchsnapshot_tpu_torch.telemetry import names


def test_schedule_is_deterministic_with_churn():
    cfg = CdnStormConfig(fleet_size=4, steps=3, chunks_per_step=8, churn_fraction=0.25)
    schedule, blobs = build_step_chunks(cfg)
    again, _ = build_step_chunks(cfg)
    assert schedule == again
    assert len(schedule) == cfg.warmup_steps + cfg.steps
    # Step 0 is all new; later steps churn exactly 2 of 8 chunks.
    assert len(schedule[0]) == 8
    for prev, cur in zip(schedule, schedule[1:]):
        assert len(set(cur) - set(prev)) == 2
    for data in blobs.values():
        assert len(data) == cfg.chunk_bytes


def test_storm_converges_at_one_x_amplification():
    r = run_cdn_storm(CdnStormConfig(fleet_size=6, steps=2, chunks_per_step=6, chunk_bytes=2048, timeout_s=60.0))
    assert r.converged(), (r.converged_subscribers, r.errors)
    assert not r.errors
    # Each unique chunk left durable storage exactly once, whatever the
    # fleet size.
    assert r.durable_reads == r.unique_chunks_published
    assert r.read_amplification == 1.0
    # The rolling update shipped only churned chunks.
    assert 0.0 < r.dedup_ratio < 1.0
    assert r.bytes_on_wire < r.bytes_in_steps
    assert r.peer_fallbacks == 0
    # Staleness covers the measured (post-warmup) steps of every member.
    assert r.staleness_samples == 6 * 2
    assert r.staleness_max_s >= r.staleness_median_s >= 0.0
    assert set(r.pull_latency) == {"durable", "peer"}
    # The wire report: the fleet's peer pulls rode the peer endpoint, one
    # RPC per pulled chunk at least.
    assert r.wire is not None
    assert r.wire["frames"] > 0 and r.wire["bytes"] > 0
    assert r.wire["ops"][names.RPC_PEER_PULL]["rpcs"] > 0


def test_storm_without_swapper_still_tracks():
    r = run_cdn_storm(
        CdnStormConfig(fleet_size=3, steps=1, chunks_per_step=4, chunk_bytes=1024, swap=False, timeout_s=30.0)
    )
    assert r.converged() and not r.errors
    assert r.read_amplification == 1.0


def test_storm_restores_pull_timeout_env():
    prior = os.environ.get("TORCHSNAPSHOT_TPU_CDN_PULL_TIMEOUT_SECONDS")
    run_cdn_storm(CdnStormConfig(fleet_size=2, steps=1, chunks_per_step=2, chunk_bytes=512, timeout_s=30.0))
    assert os.environ.get("TORCHSNAPSHOT_TPU_CDN_PULL_TIMEOUT_SECONDS") == prior
