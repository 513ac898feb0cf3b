"""Partitioner of the port: greedy write-load balancing of replicated
state and post-gather consolidation.

Port of the JAX package's ``tests/test_partitioner.py``, plus the two
packages' partitioners on the same state: they must give the same rank
the same replicated blob, or a snapshot's layout would depend on which
package took it. Multi-rank execution is simulated with threads over an
InProcessStore (the partitioner only exchanges metadata). Everything is
compared exactly (paths, ranks, entries).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.dist_store import InProcessStore
from torchsnapshot_tpu_torch.io_preparer import DeviceCopier, prepare_write
from torchsnapshot_tpu_torch.io_types import WriteReq
from torchsnapshot_tpu_torch.manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    Shard,
)
from torchsnapshot_tpu_torch.partitioner import (
    consolidate_replicated_entries,
    partition_write_reqs,
)
from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
from torchsnapshot_tpu_torch.test_utils import ProcessGroup


def rand_array(shape, dtype: str = "float32", seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _rank_reqs(
    rank: int, personal_rows: int, replicated_specs: Dict[str, int]
) -> Tuple[Dict[str, Entry], List[WriteReq]]:
    """Build one rank's manifest + write reqs: a personal array plus the
    shared replicated arrays (identical across ranks by construction)."""
    entries: Dict[str, Entry] = {}
    reqs: List[WriteReq] = []
    entry, wrs = prepare_write(
        torch.from_numpy(rand_array((personal_rows, 256), "float32", seed=rank)),
        "personal",
        rank=rank,
        copier=DeviceCopier(),
        replicated=False,
    )
    entries["personal"] = entry
    reqs.extend(wrs)
    for name, rows in replicated_specs.items():
        entry, wrs = prepare_write(
            torch.from_numpy(rand_array((rows, 256), "float32", seed=100)),
            name,
            rank=rank,
            copier=DeviceCopier(),
            replicated=True,
        )
        entries[name] = entry
        reqs.extend(wrs)
    return entries, reqs


def _run_partition(
    world_size: int, personal_rows_by_rank: List[int], replicated_specs: Dict[str, int]
) -> List[List[WriteReq]]:
    store = InProcessStore()

    def fn(rank: int) -> List[WriteReq]:
        pg = PGWrapper(ProcessGroup(store=store, rank=rank, world_size=world_size))
        entries, reqs = _rank_reqs(
            rank, personal_rows_by_rank[rank], replicated_specs
        )
        _, kept = partition_write_reqs(entries, reqs, pg)
        return kept

    with ThreadPoolExecutor(max_workers=world_size) as ex:
        futs = [ex.submit(fn, r) for r in range(world_size)]
        return [f.result(timeout=60) for f in futs]


def test_each_replicated_path_written_exactly_once() -> None:
    replicated = {"a": 8, "b": 16, "c": 24, "d": 4, "e": 12}
    kept_by_rank = _run_partition(3, [4, 4, 4], replicated)
    seen: Dict[str, int] = {}
    for rank, kept in enumerate(kept_by_rank):
        # Every rank keeps its own personal write.
        personal = [r for r in kept if r.path == f"{rank}/personal"]
        assert len(personal) == 1
        for req in kept:
            if req.path.startswith("replicated/"):
                assert req.path not in seen, "path assigned to two ranks"
                seen[req.path] = rank
    assert sorted(seen) == sorted(f"replicated/{k}" for k in replicated)


def test_greedy_assignment_balances_loads() -> None:
    """A rank with a heavy unavoidable personal load receives less
    replicated work."""
    replicated = {f"r{i}": 8 for i in range(8)}
    kept_by_rank = _run_partition(2, [512, 4], replicated)
    rep_bytes = [
        sum(
            r.buffer_stager.get_staging_cost_bytes()
            for r in kept
            if r.path.startswith("replicated/")
        )
        for kept in kept_by_rank
    ]
    # Rank 0's personal array (512x256 fp32 = 512 KB) dwarfs the total
    # replicated volume (8 * 8 KB); everything replicated goes to rank 1.
    assert rep_bytes[0] == 0
    assert rep_bytes[1] > 0


def test_world1_keeps_everything() -> None:
    pg = PGWrapper(None)
    entries, reqs = _rank_reqs(0, 4, {"a": 8})
    _, kept = partition_write_reqs(entries, reqs, pg)
    assert kept == reqs


def test_disable_partitioner_raises() -> None:
    store = InProcessStore()
    pg = PGWrapper(ProcessGroup(store=store, rank=0, world_size=2))
    entries, reqs = _rank_reqs(0, 4, {"a": 8})
    import os

    os.environ["TORCHSNAPSHOT_TPU_DISABLE_PARTITIONER"] = "1"
    try:
        with pytest.raises(NotImplementedError):
            partition_write_reqs(entries, reqs, pg)
    finally:
        del os.environ["TORCHSNAPSHOT_TPU_DISABLE_PARTITIONER"]


def test_chunked_replicated_chunks_spread_across_ranks() -> None:
    """Chunked entries are sub-partitionable: with one large replicated
    chunked array and equal base loads, both ranks get some chunks."""
    with knobs.override_max_chunk_size_bytes(256 * 64):  # 16 rows per chunk
        kept_by_rank = _run_partition(2, [1, 1], {"big": 64})  # 4 chunks
    rep_counts = [
        sum(1 for r in kept if r.path.startswith("replicated/"))
        for kept in kept_by_rank
    ]
    assert sum(rep_counts) == 4
    assert rep_counts[0] > 0 and rep_counts[1] > 0


def test_four_rank_uneven_loads_balance() -> None:
    """4-rank bin-packing with uneven pre-loads: every replicated path
    lands on exactly one rank, and the heavily pre-loaded rank receives the
    least replicated volume."""
    replicated = {f"r{i}": 8 + 4 * i for i in range(12)}
    kept_by_rank = _run_partition(4, [256, 2, 2, 2], replicated)
    seen: Dict[str, int] = {}
    rep_bytes = []
    for rank, kept in enumerate(kept_by_rank):
        total = 0
        for req in kept:
            if req.path.startswith("replicated/"):
                assert req.path not in seen, "path assigned to two ranks"
                seen[req.path] = rank
                total += req.buffer_stager.get_staging_cost_bytes()
        rep_bytes.append(total)
    assert sorted(seen) == sorted(f"replicated/{k}" for k in replicated)
    # Greedy argmin balances per rank: the 360 replicated rows split
    # ~evenly over the three light ranks (~120 each), never catching up
    # to rank 0's 256-row pre-load — so rank 0 receives nothing.
    assert rep_bytes[0] == 0
    assert all(b > 0 for b in rep_bytes[1:])


def test_four_rank_chunked_subpartition_spreads_all_ranks() -> None:
    """A sub-partitionable chunked replicated entry spreads chunk-wise
    over all 4 ranks when base loads are equal."""
    with knobs.override_max_chunk_size_bytes(256 * 16):  # 4 rows per chunk
        kept_by_rank = _run_partition(4, [1, 1, 1, 1], {"big": 64})  # 16 chunks
    rep_counts = [
        sum(1 for r in kept if r.path.startswith("replicated/"))
        for kept in kept_by_rank
    ]
    assert sum(rep_counts) == 16
    assert all(c > 0 for c in rep_counts), rep_counts


# ---------------------------------------------------------------------------
# consolidate_replicated_entries
# ---------------------------------------------------------------------------


def _arr_entry(location: str, replicated: bool = True) -> ArrayEntry:
    return ArrayEntry(
        location=location,
        serializer="buffer_protocol",
        dtype="float32",
        shape=[4],
        replicated=replicated,
    )


def test_consolidate_identical_entries() -> None:
    m0 = {"x": _arr_entry("replicated/x"), "y": _arr_entry("0/y", replicated=False)}
    m1 = {"x": _arr_entry("replicated/x")}
    merged = consolidate_replicated_entries([m0, m1])
    assert sorted(merged) == ["x"]
    assert merged["x"] == _arr_entry("replicated/x")


def test_consolidate_prefers_batch_rewritten_entry() -> None:
    plain = _arr_entry("replicated/x")
    rewritten = ArrayEntry(
        location="batched/u-u-i-d",
        serializer="buffer_protocol",
        dtype="float32",
        shape=[4],
        replicated=True,
        byte_range=[0, 16],
    )
    for order in ([{"x": plain}, {"x": rewritten}], [{"x": rewritten}, {"x": plain}]):
        merged = consolidate_replicated_entries(order)
        assert merged["x"].location == "batched/u-u-i-d"


def test_consolidate_mismatch_raises() -> None:
    a = _arr_entry("replicated/x")
    b = ArrayEntry(
        location="replicated/x",
        serializer="buffer_protocol",
        dtype="float64",  # genuine payload mismatch
        shape=[4],
        replicated=True,
    )
    with pytest.raises(AssertionError, match="mismatch"):
        consolidate_replicated_entries([{"x": a}, {"x": b}])


def test_consolidate_unions_chunked_entries() -> None:
    def chunk(start: int) -> Shard:
        return Shard(
            offsets=[start],
            sizes=[4],
            array=_arr_entry(f"replicated/big_{start}"),
        )

    def chunked(chunks: List[Shard]) -> ChunkedArrayEntry:
        return ChunkedArrayEntry(
            dtype="float32", shape=[8], chunks=chunks, replicated=True
        )

    m0 = {"big": chunked([chunk(0), chunk(4)])}
    m1 = {"big": chunked([chunk(0), chunk(4)])}
    merged = consolidate_replicated_entries([m0, m1])
    offs = [c.offsets[0] for c in merged["big"].chunks]
    assert offs == [0, 4]


# ---------------------------------------------------------------------------
# The two packages' partitioners agree
# ---------------------------------------------------------------------------


def _jax_partition(world_size: int, personal_rows: List[int], replicated: Dict[str, int]):
    """The JAX package's partitioner on the same numpy state."""
    from torchsnapshot_tpu.dist_store import InProcessStore as JStore
    from torchsnapshot_tpu.dist_store import ProcessGroup as JProcessGroup
    from torchsnapshot_tpu.io_preparer import prepare_write as jprepare_write
    from torchsnapshot_tpu.partitioner import partition_write_reqs as jpartition
    from torchsnapshot_tpu.pg_wrapper import PGWrapper as JPGWrapper

    store = JStore()

    def fn(rank: int):
        pg = JPGWrapper(JProcessGroup(store=store, rank=rank, world_size=world_size))
        entries, reqs = {}, []
        entry, wrs = jprepare_write(
            rand_array((personal_rows[rank], 256), "float32", seed=rank), "personal",
            rank=rank, replicated=False,
        )
        entries["personal"] = entry
        reqs.extend(wrs)
        for name, rows in replicated.items():
            entry, wrs = jprepare_write(
                rand_array((rows, 256), "float32", seed=100), name, rank=rank, replicated=True
            )
            entries[name] = entry
            reqs.extend(wrs)
        _, kept = jpartition(entries, reqs, pg)
        return kept

    with ThreadPoolExecutor(max_workers=world_size) as ex:
        return [f.result(timeout=60) for f in [ex.submit(fn, r) for r in range(world_size)]]


@pytest.mark.parametrize(
    "world_size, personal_rows, replicated, chunk_bytes",
    [
        (2, [512, 4], {f"r{i}": 8 for i in range(8)}, None),
        (4, [256, 2, 2, 2], {f"r{i}": 8 + 4 * i for i in range(12)}, None),
        (3, [1, 7, 3], {"big": 64, "small": 3}, 256 * 16),
    ],
    ids=["two-ranks", "four-ranks-uneven", "three-ranks-chunked"],
)
def test_same_assignment_as_the_jax_package(world_size, personal_rows, replicated, chunk_bytes) -> None:
    from torchsnapshot_tpu import knobs as jknobs

    def paths(kept_by_rank):
        return [sorted(r.path for r in kept) for kept in kept_by_rank]

    if chunk_bytes is None:
        ours = _run_partition(world_size, personal_rows, replicated)
        theirs = _jax_partition(world_size, personal_rows, replicated)
    else:
        with knobs.override_max_chunk_size_bytes(chunk_bytes), jknobs.override_max_chunk_size_bytes(
            chunk_bytes
        ):
            ours = _run_partition(world_size, personal_rows, replicated)
            theirs = _jax_partition(world_size, personal_rows, replicated)
    assert paths(ours) == paths(theirs)
