"""PGWrapper object collectives of the port: world-1 fast paths and
multi-rank semantics over a thread-shared store.

Port of the JAX package's ``tests/test_pg_wrapper.py``. Threads over an
InProcessStore replace process fan-out: the collectives only move pickled
metadata, so thread-level concurrency exercises the same paths. Results
are compared exactly (they are Python objects).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List

import pytest

from torchsnapshot_tpu_torch.dist_store import InProcessStore
from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
from torchsnapshot_tpu_torch.test_utils import ProcessGroup


def run_ranks(world_size: int, fn: Callable[[PGWrapper], Any]) -> List[Any]:
    """Run ``fn(pg)`` concurrently for every rank over one shared store."""
    store = InProcessStore()
    pgs = [
        PGWrapper(ProcessGroup(store=store, rank=r, world_size=world_size))
        for r in range(world_size)
    ]
    with ThreadPoolExecutor(max_workers=world_size) as ex:
        futs = [ex.submit(fn, pg) for pg in pgs]
        return [f.result(timeout=60) for f in futs]


def test_world1_noops() -> None:
    pg = PGWrapper(None)
    assert pg.get_rank() == 0
    assert pg.get_world_size() == 1
    pg.barrier()
    assert pg.all_gather_object("x") == ["x"]
    assert pg.broadcast_object({"a": 1}) == {"a": 1}
    assert pg.scatter_object_list(["only"]) == "only"


def test_wrap_existing_pgwrapper() -> None:
    inner = PGWrapper(None)
    outer = PGWrapper(inner)
    assert outer.get_rank() == 0 and outer.get_world_size() == 1


@pytest.mark.parametrize("world_size", [2, 4])
def test_all_gather_object(world_size: int) -> None:
    results = run_ranks(
        world_size, lambda pg: pg.all_gather_object({"rank": pg.get_rank()})
    )
    expected = [{"rank": r} for r in range(world_size)]
    for res in results:
        assert res == expected  # rank order preserved


def test_broadcast_object_nondefault_src() -> None:
    def fn(pg: PGWrapper) -> Any:
        obj = f"from-{pg.get_rank()}" if pg.get_rank() == 1 else None
        return pg.broadcast_object(obj, src=1)

    assert run_ranks(3, fn) == ["from-1"] * 3


def test_agree_object_rank0_decides() -> None:
    """agree_object: rank 0's value reaches every rank; world-1 passes
    through."""
    out = run_ranks(3, lambda pg: pg.agree_object(f"rank{pg.get_rank()}"))
    assert out == ["rank0"] * 3
    assert PGWrapper(None).agree_object("solo") == "solo"


def test_scatter_object_list() -> None:
    def fn(pg: PGWrapper) -> Any:
        objs = (
            [f"item-{i}" for i in range(pg.get_world_size())]
            if pg.get_rank() == 0
            else None
        )
        return pg.scatter_object_list(objs)

    assert run_ranks(4, fn) == [f"item-{i}" for i in range(4)]


def test_sequenced_collectives_do_not_collide() -> None:
    """Back-to-back collectives on the same wrapper get distinct key
    prefixes, so a fast rank's round N+1 can't consume round N keys."""

    def fn(pg: PGWrapper) -> Any:
        out = []
        for i in range(5):
            out.append(pg.all_gather_object((pg.get_rank(), i)))
            pg.barrier()
        return out

    results = run_ranks(2, fn)
    for res in results:
        for i, gathered in enumerate(res):
            assert gathered == [(0, i), (1, i)]


def test_barrier_releases_all_ranks() -> None:
    import threading

    arrived = []
    lock = threading.Lock()

    def fn(pg: PGWrapper) -> int:
        with lock:
            arrived.append(pg.get_rank())
        pg.barrier()
        with lock:
            # Nobody passes the barrier until everyone arrived.
            assert len(arrived) == pg.get_world_size()
        return pg.get_rank()

    assert sorted(run_ranks(4, fn)) == [0, 1, 2, 3]


def test_counter_shared_across_pgs_on_same_store() -> None:
    """Two distinct ProcessGroup objects over the same store must share one
    op-seq counter: store-key collisions are scoped to the store, so
    independent counters could alias ``__pg/*`` keys (e.g. one pg handed to
    CheckpointManager and another to Snapshot)."""
    store = InProcessStore()
    pg_a = ProcessGroup(store=store, rank=0, world_size=2)
    pg_b = ProcessGroup(store=store, rank=0, world_size=2)
    wa = PGWrapper(pg_a)
    wb = PGWrapper(pg_b)
    assert wa._op_seq_ref is wb._op_seq_ref
    p1 = wa._next_prefix("ag")
    p2 = wb._next_prefix("ag")
    assert p1 != p2


def test_store_rank_world_triple() -> None:
    """A plain ``(store, rank, world_size)`` tuple is a process group too,
    sharing the op sequence of any other group over the same store."""
    store = InProcessStore()
    triple = PGWrapper((store, 1, 2))
    assert (triple.get_rank(), triple.get_world_size(), triple.store) == (1, 2, store)
    assert triple._op_seq_ref is PGWrapper(ProcessGroup(store=store, rank=1, world_size=2))._op_seq_ref
    results = run_ranks(2, lambda pg: PGWrapper((pg.store, pg.rank, pg.world_size)).all_gather_object(pg.rank))
    assert results == [[0, 1], [0, 1]]
