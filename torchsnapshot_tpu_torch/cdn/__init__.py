"""Checkpoint CDN: pub/sub weight streaming from training to serving.

Counterpart of ``torchsnapshot_tpu/cdn/``, with its store keys, announce
records and peer transport, so that either package's subscriber tracks
the other's topic. The training job's ``CheckpointManager`` *publishes*
each committed step (its chunk-store keys) to a topic on the
coordination store; a serving fleet *subscribes*, pulls only the novel
chunks, mostly from each other with one durable read per chunk, and
hot-swaps them in behind a pointer flip (onto CUDA cards, the CPU or
numpy). Default OFF (``TORCHSNAPSHOT_TPU_CDN=1`` and a manager
``cdn_topic`` turn the publish side on; subscribers are explicit
objects).
"""

from .publisher import CdnPublisher
from .subscriber import (
    CdnSubscriber,
    CdnSyncError,
    SubscriberStats,
    durable_chunk_reader,
)
from .swap import SwapError, WeightSwapper, concat_assembler
from .topic import (
    CDN_SERVICE,
    TOPIC_PREFIX,
    Announce,
    announce_key,
    head_key,
    manifest_digest,
    read_announce,
    read_head,
    verify_chunk_bytes,
)

__all__ = [
    "Announce",
    "CDN_SERVICE",
    "CdnPublisher",
    "CdnSubscriber",
    "CdnSyncError",
    "SubscriberStats",
    "SwapError",
    "TOPIC_PREFIX",
    "WeightSwapper",
    "announce_key",
    "concat_assembler",
    "durable_chunk_reader",
    "head_key",
    "manifest_digest",
    "read_announce",
    "read_head",
    "verify_chunk_bytes",
]
