"""Uniform object-collective interface for snapshot coordination.

Counterpart of ``torchsnapshot_tpu/pg_wrapper.py``. Only metadata moves
through these collectives (manifests, plans, step numbers), never tensor
data. This package runs in one process so far: ``pg=None`` gives the
world-size-1 fast path of every collective. A process group needs the
coordination store of ``dist_store.py``, which comes with the
multi-process port (ROADMAP queue 1 step 5); until then it is refused.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence


class PGWrapper:
    """Object collectives with a world-size-1 fast path.

    ``pg`` may be ``None`` (single process) or an existing
    :class:`PGWrapper`; a process group is refused until the
    multi-process port."""

    def __init__(self, pg: Optional[Any] = None) -> None:
        if pg is not None and not isinstance(pg, PGWrapper):
            raise NotImplementedError(
                "torchsnapshot_tpu_torch runs in one process (pg=None); a "
                "process group needs the coordination store of the "
                "multi-process port (ROADMAP queue 1 step 5)"
            )
        # The coordination store a multi-process world shares; None here.
        self.store: Optional[Any] = None
        self.rank = 0
        self.world_size = 1

    def get_rank(self) -> int:
        return self.rank

    def get_world_size(self) -> int:
        return self.world_size

    def barrier(self) -> None:
        return

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Gather one picklable object per rank, returned in rank order."""
        return [obj]

    def gather_object(self, obj: Any, dst: int = 0) -> Optional[List[Any]]:
        """Gather one picklable object per rank to ``dst`` (rank order)."""
        return [obj]

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Broadcast ``obj`` from ``src``; other ranks' inputs are ignored."""
        return obj

    def agree_object(self, obj: Any) -> Any:
        """Rank 0 decides, everyone follows."""
        return self.broadcast_object(obj)

    def scatter_object_list(self, objs: Optional[Sequence[Any]], src: int = 0) -> Any:
        """Rank ``src`` provides one object per rank; each rank receives its
        own."""
        assert objs is not None
        return objs[0]
