"""The training job's side of the CDN: announce committed steps.

Counterpart of ``torchsnapshot_tpu/cdn/publisher.py``. One
:class:`CdnPublisher` per manager root and topic, driven from rank 0's
post-commit hook (``manager.py``). Publishing is two store writes, the
announce record and then the head bump, with the ``cdn-publish-announced``
crash point between them: the only torn state a kill there leaves is an
announce record no subscriber reads (the head still names the previous
seq), which the next publish overwrites. No barrier and no wait for
acknowledgements: the training job never blocks on the serving fleet.

Publishing is metadata only: the chunks were made durable by the commit
the announce describes. A publish failure degrades the fleet's freshness,
never the training job's checkpoint.

With ``root`` (the manager root), each publish posts ``cdn-published``
to that root's run ledger, as the JAX package does. The two writes run
inside ``wire.propagate(RPC_CDN_PUBLISH)``; with the fleet metrics plane
on (``TORCHSNAPSHOT_TPU_FLEET_OBS=1``) the publisher keeps one
``__obs/publisher/<id>`` snapshot, refreshed per publish and reaped by
:meth:`CdnPublisher.close`.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

from .. import knobs, telemetry
from ..chaos import crashpoint
from ..dist_store import Store
from ..telemetry import ledger
from ..telemetry import names as metric_names
from ..telemetry import wire
from ..telemetry.trace import get_recorder as _trace_recorder
from .topic import Announce, announce_key, head_key, manifest_digest, read_head

logger = logging.getLogger(__name__)

# Announce records kept behind the head. Subscribers read only the
# announce the head names, so one extra record covers a poll that read
# the head just before a publish; two keep the previous publish readable
# for a post-mortem without growing the store.
_ANNOUNCE_RETAIN = 2


class CdnPublisher:
    """Publish committed steps' chunk sets to one topic. ``root`` (the
    manager's root URL) receives a ``cdn-published`` ledger event per
    publish (only where a run ledger exists); omit it for store-only
    publishing."""

    def __init__(
        self,
        store: Store,
        topic: str,
        publisher_id: str = "",
        root: Optional[str] = None,
    ) -> None:
        self._store = store
        self.topic = topic
        self.publisher_id = publisher_id
        self._root = root
        # The head, cached: the publisher is the topic's single writer, so
        # after one read it alone knows the tip.
        self._seq: Optional[int] = None
        self._fleet: Optional[wire.FleetReporter] = None
        if knobs.is_fleet_obs_enabled():
            self._fleet = wire.FleetReporter(store, "publisher", publisher_id or topic)

    @property
    def last_seq(self) -> int:
        if self._seq is None:
            self._seq = read_head(self._store, self.topic)
        return self._seq

    def publish(self, step: int, chunks: Dict[str, int]) -> Optional[Announce]:
        """Announce one committed step. Returns the announce, or None when
        the store rejected the writes (logged, never raised)."""
        seq = self.last_seq + 1
        ann = Announce(
            topic=self.topic,
            seq=seq,
            step=int(step),
            digest=manifest_digest(step, chunks),
            chunks=dict(chunks),
            published_ts=time.time(),
            publisher=self.publisher_id,
        )
        encoded = ann.encode()
        try:
            with wire.propagate(metric_names.RPC_CDN_PUBLISH), _trace_recorder().span(
                metric_names.SPAN_CDN_PUBLISH, topic=self.topic, step=int(step)
            ):
                # Record first, head second: the head is the commit marker.
                self._store.set(announce_key(self.topic, seq), encoded)
                crashpoint(metric_names.CRASH_CDN_PUBLISH_ANNOUNCED)
                self._store.set(head_key(self.topic), str(seq).encode())
        except Exception as e:  # noqa: BLE001 - never fail the training job
            logger.warning("cdn: publish of step %d to topic %r failed: %r", step, self.topic, e)
            self._seq = None  # the head is unknown: re-read it next publish
            return None
        self._seq = seq
        # Reap the announce that just left the retention window. ``seq`` is
        # continuous across restarts (``last_seq`` re-reads the head), so one
        # delete per publish covers every record ever written.
        if seq > _ANNOUNCE_RETAIN:
            try:
                self._store.delete(announce_key(self.topic, seq - _ANNOUNCE_RETAIN))
            except Exception:  # noqa: BLE001 - retention is best-effort
                pass
        registry = telemetry.metrics()
        registry.counter_inc(metric_names.CDN_PUBLISHES_TOTAL)
        registry.counter_inc(metric_names.CDN_ANNOUNCE_BYTES_TOTAL, float(len(encoded)))
        if self._fleet is not None:
            self._publish_fleet(step, seq, len(chunks))
        if self._root is not None:
            ledger.post_event(
                self._root,
                metric_names.EVENT_CDN_PUBLISHED,
                topic=self.topic,
                seq=seq,
                step=int(step),
                chunks=len(chunks),
                bytes_in_step=ann.bytes_in_step,
                published_ts=round(ann.published_ts, 6),
            )
        return ann

    def _publish_fleet(self, step: int, seq: int, nchunks: int) -> None:
        """Refresh this publisher's fleet snapshot, with the training job's
        SLO burn rate (the fleet table's BURN column) where one is known."""
        try:
            extra = {"seq": seq, "chunks": nchunks}
            try:
                from ..telemetry import slo

                burn = slo.current_burn()
                if burn is not None:
                    extra["slo_burn"] = round(burn, 4)
            except Exception:  # noqa: BLE001 - observability never blocks
                pass
            self._fleet.publish(phase=f"published:{int(step)}", extra=extra)
        except Exception:  # noqa: BLE001 - observability never blocks
            pass

    def close(self) -> None:
        """Reap this publisher's fleet-plane snapshot, if it keeps one."""
        if self._fleet is not None:
            self._fleet.close()
            self._fleet = None
