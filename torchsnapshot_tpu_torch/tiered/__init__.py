"""Tiered checkpointing: a fast local commit and a background mirror to
durable storage.

Counterpart of ``torchsnapshot_tpu/tiered/``:

- :class:`TieredStoragePlugin` (``plugin.py``) composes a fast tier, which
  every take writes through and commits against, and a durable tier that
  a background :class:`Mirror` copies committed bytes to. Reads resolve
  fast first with a per-blob durable fallback, so an evicted fast tier is
  transparent to restore; a blob whose fast bytes fail verification heals
  from the durable copy.
- :class:`Mirror` (``mirror.py``): per-blob progress journaled in the
  fast tier (``journal.py``, the JAX package's JSON schema), retries under
  the collective-progress strategy, the durable commit marker last.
- ``tiered://<fast_url>|<durable_url>`` URLs dispatch here through
  ``storage_plugin.py``; ``CheckpointManager`` adds fast-tier retention
  (``keep_fast_last_n``), ``wait_durable(step)`` and ``resume_mirrors()``.
- The peer tier (``peer.py``): every rank pushes its committed blobs into
  a neighbour rank's host-RAM cache (ring placement), and a restore reads
  each blob peer RAM -> local fast tier -> durable, falling through to
  storage on any peer failure. ``CheckpointManager(pg=...)`` brings it up
  with more than one rank; ``keep_peer_last_n`` bounds the caches.
"""

from __future__ import annotations

from .journal import JOURNAL_BACKUP_BLOB, JOURNAL_BLOB, MirrorJournal
from .mirror import Mirror, get_mirror, reset_mirror, wait_durable
from .peer import (
    PeerCache,
    PeerClient,
    PeerReplicator,
    PeerRestoreContext,
    PeerTransferError,
    get_replicator,
    reset_peer_tier,
)
from .plugin import TieredStoragePlugin

__all__ = [
    "JOURNAL_BACKUP_BLOB",
    "JOURNAL_BLOB",
    "Mirror",
    "MirrorJournal",
    "PeerCache",
    "PeerClient",
    "PeerReplicator",
    "PeerRestoreContext",
    "PeerTransferError",
    "TieredStoragePlugin",
    "get_mirror",
    "get_replicator",
    "reset_mirror",
    "reset_peer_tier",
    "wait_durable",
]
