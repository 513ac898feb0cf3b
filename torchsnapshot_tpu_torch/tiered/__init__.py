"""Tiered checkpointing: a fast local commit and a background mirror to
durable storage.

Counterpart of ``torchsnapshot_tpu/tiered/``, without the peer tier:

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

The peer tier (host-RAM copies on a neighbour rank, ``tiered/peer.py`` in
the JAX package) is not ported yet (ROADMAP queue 1 step 9b-ii).
"""

from __future__ import annotations

from .journal import JOURNAL_BACKUP_BLOB, JOURNAL_BLOB, MirrorJournal
from .mirror import Mirror, get_mirror, reset_mirror, wait_durable
from .plugin import TieredStoragePlugin

__all__ = [
    "JOURNAL_BACKUP_BLOB",
    "JOURNAL_BLOB",
    "Mirror",
    "MirrorJournal",
    "TieredStoragePlugin",
    "get_mirror",
    "reset_mirror",
    "wait_durable",
]
