"""CDN subscriber storm: a serving fleet tracking a publishing trainer.

Counterpart of ``torchsnapshot_tpu/scalemodel/cdn_storm.py``. One
publisher announces ``steps`` synthetic checkpoint steps (chunk-store
chunk sets with a per-step churn fraction: a rolling update replaces some
chunks and keeps the rest) while ``fleet_size`` subscriber threads run
the real :class:`~torchsnapshot_tpu_torch.cdn.CdnSubscriber` machinery:
each runs its own peer-cache TCP server, polls the topic head with the
world-scaled pacer, elects chunk owners, pulls novel chunks from its
peers, and hot-swaps through :class:`~torchsnapshot_tpu_torch.cdn.WeightSwapper`.

What the storm reports:

- **read amplification**: durable reads over unique chunks published,
  counted by the wrapped ``durable_fetch``. Owner election makes it about
  1.0 whatever the fleet size.
- **staleness**: publish-to-swap seconds per subscriber and step (median,
  p90, max), warmup steps excluded.
- **dedup ratio**: fleet bytes on the wire over fleet bytes in steps: a
  rolling update ships only churned chunks.

Left out against the JAX package until the telemetry port (ROADMAP step
10): the wire report, so :attr:`CdnStormResult.wire` is always None.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..cas import digest_key
from ..cdn import CdnPublisher, CdnSubscriber, WeightSwapper
from ..dist_store import InProcessStore, Store
from ..knobs import override_cdn_pull_timeout_seconds


@dataclasses.dataclass
class CdnStormConfig:
    fleet_size: int
    steps: int = 3
    # Bootstrap steps published (and applied) before measurement: the
    # fleet's first sync pulls the full chunk set (cold start), while the
    # staleness figures are about the steady state. Their staleness
    # samples are excluded; bytes and reads still count.
    warmup_steps: int = 1
    chunks_per_step: int = 8
    chunk_bytes: int = 4096
    # Fraction of the chunk set replaced each step (a rolling update);
    # 1.0 = every step all new, 0.0 = a pure re-announce.
    churn_fraction: float = 0.25
    publish_interval_s: float = 0.05
    pull_timeout_s: float = 2.0
    # Each subscriber's wait for the whole storm.
    timeout_s: float = 60.0
    topic: str = "storm"
    swap: bool = True


@dataclasses.dataclass
class CdnStormResult:
    config: CdnStormConfig
    wall_s: float
    # Durable-read accounting.
    durable_reads: int
    unique_chunks_published: int
    read_amplification: float
    # The fleet's bytes by tier.
    bytes_on_wire: int
    bytes_in_steps: int
    bytes_from_peer: int
    bytes_from_durable: int
    # Publish-to-swap staleness across all (subscriber, step) after warmup.
    staleness_median_s: float
    staleness_p90_s: float
    staleness_max_s: float
    staleness_samples: int
    # Subscribers whose final applied seq reached the schedule's end.
    converged_subscribers: int
    peer_fallbacks: int
    errors: Dict[int, str]
    # Per-tier pull-latency quantiles pooled across the fleet
    # ({tier: {p50_s, p95_s, samples}}).
    pull_latency: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    # The JAX package's per-op wire report; not ported (step 10c): None.
    wire: Optional[Dict[str, object]] = None

    @property
    def dedup_ratio(self) -> float:
        """bytes_on_wire / bytes_in_steps: under 1 means the fleet shipped
        less than the steps' logical size (held chunks served again)."""
        if self.bytes_in_steps <= 0:
            return 0.0
        return self.bytes_on_wire / self.bytes_in_steps

    def converged(self) -> bool:
        return self.converged_subscribers == self.config.fleet_size


def _make_chunk(seed: int, nbytes: int) -> Tuple[str, bytes]:
    """Deterministic unique chunk bytes and their self-describing key."""
    unit = seed.to_bytes(8, "little", signed=False)
    data = (unit * (nbytes // 8 + 1))[:nbytes]
    key = digest_key(("crc32", zlib.crc32(data), len(data)))
    return key, data


def build_step_chunks(cfg: CdnStormConfig) -> Tuple[List[Dict[str, int]], Dict[str, bytes]]:
    """The storm's publish schedule: per-step chunk sets with churn, and
    the blob map the counting ``durable_fetch`` serves."""
    blobs: Dict[str, bytes] = {}
    schedule: List[Dict[str, int]] = []
    keys: List[str] = []
    seed = 0
    for step in range(cfg.warmup_steps + cfg.steps):
        if step == 0:
            replace = cfg.chunks_per_step
        else:
            replace = max(1, int(round(cfg.chunks_per_step * cfg.churn_fraction)))
        kept = keys[: cfg.chunks_per_step - replace]
        fresh: List[str] = []
        for _ in range(replace):
            key, data = _make_chunk(seed, cfg.chunk_bytes)
            seed += 1
            blobs[key] = data
            fresh.append(key)
        keys = fresh + kept
        schedule.append({k: len(blobs[k]) for k in keys})
    return schedule, blobs


def _quantile(samples: List[float], frac: float) -> float:
    """The sorted ``samples``' ``frac`` quantile (0.0 for none)."""
    if not samples:
        return 0.0
    return samples[min(len(samples) - 1, int(len(samples) * frac))]


def run_cdn_storm(cfg: CdnStormConfig, store: Optional[Store] = None) -> CdnStormResult:
    store = store if store is not None else InProcessStore()
    schedule, blobs = build_step_chunks(cfg)
    unique_chunks = len(blobs)
    bytes_in_steps = sum(sum(c.values()) for c in schedule)

    durable_lock = threading.Lock()
    durable_reads = {"n": 0}

    def durable_fetch(key: str) -> bytes:
        with durable_lock:
            durable_reads["n"] += 1
        return blobs[key]

    # Subscribers read the pull timeout from the knob at each pull; the
    # storm pins it for its own window and restores the caller's value.
    cleanup = contextlib.ExitStack()
    cleanup.enter_context(override_cdn_pull_timeout_seconds(cfg.pull_timeout_s))
    subs: List[CdnSubscriber] = []
    errors: Dict[int, str] = {}
    errors_lock = threading.Lock()
    started = time.monotonic()
    try:
        subs = [
            CdnSubscriber(store, cfg.topic, i, cfg.fleet_size, durable_fetch=durable_fetch)
            for i in range(cfg.fleet_size)
        ]
        total_bytes = cfg.chunks_per_step * cfg.chunk_bytes
        total_steps = cfg.warmup_steps + cfg.steps
        deadline = time.monotonic() + cfg.timeout_s

        def subscriber_main(sub: CdnSubscriber) -> None:
            swapper = WeightSwapper({"w": np.zeros(total_bytes, np.uint8)}) if cfg.swap else None
            try:
                while sub.applied_seq < total_steps and time.monotonic() < deadline:
                    sub.track_once(swapper, timeout=0.25)
            except BaseException as e:  # noqa: BLE001 - recorded, not raised
                with errors_lock:
                    errors[sub.subscriber_id] = repr(e)

        threads = [threading.Thread(target=subscriber_main, args=(s,), daemon=True) for s in subs]
        for t in threads:
            t.start()

        publisher = CdnPublisher(store, cfg.topic, publisher_id="storm")
        for step, chunks in enumerate(schedule[: cfg.warmup_steps], start=1):
            publisher.publish(step, chunks)
            time.sleep(cfg.publish_interval_s)
        # Warmup barrier: wait for the fleet's cold bootstrap, then note
        # each subscriber's sample count, so that the staleness figures
        # cover the steady-state steps only.
        while any(s.applied_seq < cfg.warmup_steps for s in subs) and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(cfg.publish_interval_s)
        warmup_samples = [len(s.stats.staleness_s) for s in subs]
        for step, chunks in enumerate(schedule[cfg.warmup_steps :], start=cfg.warmup_steps + 1):
            publisher.publish(step, chunks)
            time.sleep(cfg.publish_interval_s)

        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()) + 1.0)
        wall_s = time.monotonic() - started

        staleness = sorted(s for sub, base in zip(subs, warmup_samples) for s in sub.stats.staleness_s[base:])
        pulls_by_tier: Dict[str, List[float]] = {}
        for sub in subs:
            for tier, samples in sub.stats.pull_latency_s.items():
                pulls_by_tier.setdefault(tier, []).extend(samples)
        pull_latency: Dict[str, Dict[str, float]] = {}
        for tier, samples in sorted(pulls_by_tier.items()):
            samples.sort()
            pull_latency[tier] = {
                "p50_s": round(_quantile(samples, 0.5), 6),
                "p95_s": round(_quantile(samples, 0.95), 6),
                "samples": len(samples),
            }

        return CdnStormResult(
            config=cfg,
            wall_s=round(wall_s, 3),
            durable_reads=durable_reads["n"],
            unique_chunks_published=unique_chunks,
            read_amplification=durable_reads["n"] / unique_chunks if unique_chunks else 0.0,
            bytes_on_wire=sum(s.stats.bytes_on_wire for s in subs),
            bytes_in_steps=bytes_in_steps * cfg.fleet_size,
            bytes_from_peer=sum(s.stats.bytes_from_peer for s in subs),
            bytes_from_durable=sum(s.stats.bytes_from_durable for s in subs),
            staleness_median_s=round(_quantile(staleness, 0.5), 6),
            staleness_p90_s=round(_quantile(staleness, 0.9), 6),
            staleness_max_s=round(staleness[-1], 6) if staleness else 0.0,
            staleness_samples=len(staleness),
            converged_subscribers=sum(1 for s in subs if s.applied_seq >= total_steps),
            peer_fallbacks=sum(s.stats.peer_fallbacks for s in subs),
            errors=errors,
            pull_latency=pull_latency,
        )
    finally:
        for sub in subs:
            try:
                sub.close()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
        cleanup.close()
