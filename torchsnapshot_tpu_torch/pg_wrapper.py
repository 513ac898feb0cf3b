"""Uniform object-collective interface for snapshot coordination.

Counterpart of ``torchsnapshot_tpu/pg_wrapper.py``. Only metadata moves
through these collectives (manifests, plans, paths, step numbers), never
tensor data, so they ride the small KV store of ``dist_store.py`` (a
:class:`~torchsnapshot_tpu_torch.dist_store.TCPStore`, bootstrapped by
``torch_process_group()`` in a ``torch.distributed`` job) rather than
NCCL. In a single process every collective degenerates to a no-op.
"""

from __future__ import annotations

import logging
import threading
import weakref
from typing import Any, List, Optional, Sequence

from .dist_store import ProcessGroup, Store, make_barrier

logger: logging.Logger = logging.getLogger(__name__)

# Shared op-seq storage for store objects that reject attribute assignment
# (__slots__/frozen): falls back to identity-keyed weak references. Values
# are per-rank dicts: {rank: [seq]}.
_OP_SEQ_REFS: "weakref.WeakKeyDictionary[Any, dict]" = (
    weakref.WeakKeyDictionary()
)
# Guards the check-then-set on the store's per-rank counter dict: wrappers
# for different ranks may be constructed concurrently over one store
# object (thread-based multi-rank harnesses).
_OP_SEQ_LOCK = threading.Lock()


class PGWrapper:
    """Object collectives with a world-size-1 fast path.

    ``pg`` may be ``None`` (single process), an existing :class:`PGWrapper`,
    or a ``(store, rank, world_size)`` triple / :class:`ProcessGroup`-like
    object exposing ``store``/``rank``/``world_size``.
    """

    def __init__(self, pg: Optional[Any] = None) -> None:
        # The op sequence is SHARED across every wrapper over the same
        # underlying (store, rank) — attached to the store object, keyed by
        # rank (see _shared_op_seq_ref): keyed store ops are only cleaned
        # up by the *last* rank to finish one, so a fresh wrapper
        # restarting at op 1 would overwrite a key a slow peer has not
        # read yet (e.g. a manager broadcast followed by Snapshot.take,
        # which builds its own wrapper). Call sequences are SPMD-identical
        # across ranks, so the shared counter stays aligned everywhere.
        if pg is None:
            self.store: Optional[Store] = None
            self.rank = 0
            self.world_size = 1
            self._op_seq_ref = [0]
        elif isinstance(pg, PGWrapper):
            self.store = pg.store
            self.rank = pg.rank
            self.world_size = pg.world_size
            self._op_seq_ref = pg._op_seq_ref
        else:
            if isinstance(pg, tuple):
                pg = ProcessGroup(*pg)
            self.store = pg.store
            self.rank = int(pg.rank)
            self.world_size = int(pg.world_size)
            self._op_seq_ref = _shared_op_seq_ref(pg)

    def get_rank(self) -> int:
        return self.rank

    def get_world_size(self) -> int:
        return self.world_size

    def _next_prefix(self, op: str) -> str:
        self._op_seq_ref[0] += 1
        return f"__pg/{op}/{self._op_seq_ref[0]}"

    def barrier(self) -> None:
        if self.world_size == 1:
            return
        assert self.store is not None
        # Rides make_barrier like every snapshot-phase rendezvous: the
        # O(log world) tree by default (no key with more than fanout
        # waiters — at a thousand ranks the old single go-key release
        # was a thundering herd on one hub socket), LinearBarrier
        # behind the same kill switch.
        b = make_barrier(
            self._next_prefix("barrier"), self.store, self.rank,
            self.world_size,
        )
        b.arrive()
        b.depart()

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Gather one picklable object per rank, returned in rank order."""
        if self.world_size == 1:
            return [obj]
        assert self.store is not None
        return self.store.exchange(
            self._next_prefix("ag"), self.rank, self.world_size, obj
        )

    def gather_object(self, obj: Any, dst: int = 0) -> Optional[List[Any]]:
        """Gather one picklable object per rank to ``dst`` (rank order);
        returns None on every other rank. Non-destination ranks pay
        O(own object) store traffic — use this instead of
        :meth:`all_gather_object` whenever only one rank consumes the
        result (e.g. the manifest gather: rank 0 alone writes metadata)."""
        if self.world_size == 1:
            return [obj]
        assert self.store is not None
        return self.store.gather(
            self._next_prefix("ga"), self.rank, self.world_size, obj, dst
        )

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Broadcast ``obj`` from ``src``; other ranks' inputs are ignored."""
        if self.world_size == 1:
            return obj
        assert self.store is not None
        return self.store.broadcast(
            self._next_prefix("bc"), self.rank, self.world_size, obj, src
        )

    def agree_object(self, obj: Any) -> Any:
        """Rank 0 decides, everyone follows: broadcast rank 0's ``obj``
        and return it on every rank (other ranks' inputs are ignored;
        world-size-1 returns ``obj`` untouched). The blessed way to turn
        a knob/env reading into a job-wide decision *before* gating any
        collective work on it — the result is rank-uniform by
        construction, so a guard over it can never skew a rendezvous."""
        return self.broadcast_object(obj)

    def scatter_object_list(self, objs: Optional[Sequence[Any]], src: int = 0) -> Any:
        """Rank ``src`` provides one object per rank; each rank receives its
        own. (The reference emulates this over broadcast for NCCL,
        pg_wrapper.py:83-87; over a store it is a direct exchange.)"""
        if self.world_size == 1:
            assert objs is not None
            return objs[0]
        assert self.store is not None
        return self.store.scatter(
            self._next_prefix("sc"), self.rank, self.world_size, objs, src
        )


def _shared_op_seq_ref(pg: Any) -> List[int]:
    """One op-seq counter per ``(store, rank)``, surviving wrapper and pg
    churn. Store-key collisions are scoped to the *store*, not the pg: two
    ProcessGroup objects wrapping the same store (e.g. two
    ``torch_process_group()`` calls, one handed to CheckpointManager and one
    to Snapshot) must share one ``__pg/*`` namespace counter. The rank is
    part of the key because each rank mirrors the global op sequence
    through its own call stream (relevant when a test harness runs several
    ranks as threads over one store object). Attribute attachment first;
    weak-ref registry for frozen/slots stores; only truly un-referenceable
    keys degrade to per-wrapper sequences (loudly — aliasing re-appears
    then)."""
    key = getattr(pg, "store", None)
    if key is None:
        key = pg
    rank = int(getattr(pg, "rank", 0))
    with _OP_SEQ_LOCK:
        refs = getattr(key, "_ts_op_seq_refs", None)
        if refs is None:
            refs = {}
            try:
                key._ts_op_seq_refs = refs
            except Exception:
                try:
                    refs = _OP_SEQ_REFS.setdefault(key, {})
                except TypeError:
                    logger.warning(
                        "Store %r accepts neither attributes nor weak "
                        "references; store-key sequences degrade to "
                        "per-wrapper and may alias across wrappers",
                        type(key).__name__,
                    )
                    return [0]
        return refs.setdefault(rank, [0])
