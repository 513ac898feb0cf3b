"""Replication glob semantics of the port: pattern matching, cross-rank
intersection, and existence verification.

Port of the JAX package's ``tests/test_replication_glob.py``. The
thread-over-InProcessStore harness replaces process fan-out for the pure
coordination logic; the end-to-end multiprocess cases live in
``tests/test_torch_distributed_snapshot.py``. Results are compared
exactly (sets of paths).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List

import torch

from torchsnapshot_tpu_torch.dist_store import InProcessStore
from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
from torchsnapshot_tpu_torch.snapshot import (
    _calculate_replicated_entries,
    _coalesce_replicated,
)
from torchsnapshot_tpu_torch.test_utils import ProcessGroup


def run_ranks(world_size: int, fn: Callable[[PGWrapper, int], Any]) -> List[Any]:
    store = InProcessStore()
    pgs = [
        PGWrapper(ProcessGroup(store=store, rank=r, world_size=world_size))
        for r in range(world_size)
    ]
    with ThreadPoolExecutor(max_workers=world_size) as ex:
        futs = [ex.submit(fn, pg, r) for r, pg in enumerate(pgs)]
        return [f.result(timeout=60) for f in futs]


FLATTENED: Dict[str, Any] = {
    "model/layer0/w": torch.ones(2),
    "model/layer0/b": torch.ones(2),
    "model/layer1/w": torch.ones(2),
    "optim/step": 3,
    "optim/layer0/m": torch.ones(2),
}


def test_single_process_glob_matching() -> None:
    pg = PGWrapper(None)
    assert _calculate_replicated_entries(FLATTENED, ["**"], pg) == set(FLATTENED)
    assert _calculate_replicated_entries(FLATTENED, ["model/**"], pg) == {
        "model/layer0/w",
        "model/layer0/b",
        "model/layer1/w",
    }
    # fnmatch "*" crosses "/" (it is not a filesystem glob): document that.
    assert _calculate_replicated_entries(FLATTENED, ["model/*/w"], pg) == {
        "model/layer0/w",
        "model/layer1/w",
    }
    assert _calculate_replicated_entries(FLATTENED, ["optim/step"], pg) == {
        "optim/step"
    }
    assert _calculate_replicated_entries(FLATTENED, [], pg) == set()
    assert _calculate_replicated_entries(FLATTENED, ["nomatch/**"], pg) == set()


def test_multi_pattern_union() -> None:
    pg = PGWrapper(None)
    got = _calculate_replicated_entries(
        FLATTENED, ["optim/step", "model/layer1/**"], pg
    )
    assert got == {"optim/step", "model/layer1/w"}


def test_coalesce_intersects_patterns_across_ranks() -> None:
    def fn(pg: PGWrapper, rank: int) -> List[str]:
        patterns = ["model/**", "optim/**"] if rank == 0 else ["model/**"]
        return _coalesce_replicated(patterns, pg)

    for res in run_ranks(2, fn):
        assert res == ["model/**"]


def test_coalesce_world1_passthrough() -> None:
    assert _coalesce_replicated(["a", "b"], PGWrapper(None)) == ["a", "b"]


def test_path_missing_on_one_rank_not_replicated() -> None:
    """A matched path must exist on every rank to be treated as
    replicated."""

    def fn(pg: PGWrapper, rank: int) -> set:
        flattened = dict(FLATTENED)
        if rank == 1:
            del flattened["model/layer1/w"]  # only rank 0 has it
        return _calculate_replicated_entries(flattened, ["model/**"], pg)

    for res in run_ranks(2, fn):
        assert res == {"model/layer0/w", "model/layer0/b"}


def test_all_ranks_agree_on_result() -> None:
    def fn(pg: PGWrapper, rank: int) -> set:
        return _calculate_replicated_entries(FLATTENED, ["**"], pg)

    results = run_ranks(3, fn)
    assert results[0] == results[1] == results[2] == set(FLATTENED)
