"""Metadata-plane scaling of the port: the manifest gather (and the
partitioner's and replication verification's) go to the leader; other
ranks pay coordinator traffic of the order of their own manifest, not of
world x manifest.

Port of the JAX package's ``tests/test_manifest_gather.py``:

- correctness: a distributed take, then every rank restores; the ranks
  other than 0 hold no in-memory metadata after the take and read the
  committed metadata lazily;
- traffic: with a large manifest, each non-leader's received coordinator
  bytes stay a small fraction of the leader's. Restored state is compared
  bit for bit.
"""

import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
from torchsnapshot_tpu_torch.dist_store import ProcessGroup
from torchsnapshot_tpu_torch.test_utils import ByteCountingStore, run_multiprocess

N_LEAVES = 300  # per rank: a pickled rank manifest of tens of KB


def _traffic_worker(pg, root: str):
    counting = ByteCountingStore(pg.store)
    cpg = ProcessGroup(store=counting, rank=pg.rank, world_size=pg.world_size)
    state = {f"t{i:04d}": torch.full((4,), float(pg.rank * 100_000 + i)) for i in range(N_LEAVES)}
    snap = Snapshot.take(root, {"m": TensorTreeState(state)}, pg=cpg)
    take_sent, take_received = counting.sent_bytes, counting.received_bytes
    md = snap.metadata
    assert md.world_size == pg.world_size
    assert f"{pg.rank}/m/t0000" in md.manifest
    dest = TensorTreeState({f"t{i:04d}": torch.zeros(4) for i in range(N_LEAVES)})
    Snapshot(root, pg=cpg).restore({"m": dest})
    for k, v in state.items():
        assert torch.equal(dest.tree[k], v), k
    return take_sent, take_received


def test_manifest_gather_traffic_is_leader_bound(tmp_path) -> None:
    results = run_multiprocess(_traffic_worker, nproc=4, args=(str(tmp_path / "snap"),))
    sent = [s for s, _ in results]
    received = [r for _, r in results]
    # Every non-leader shipped its own manifest; the leader's own blob
    # never touches the store, so its sent column is control traffic.
    assert all(s > 10_000 for s in sent[1:]), sent
    assert sent[0] < min(sent[1:]) / 3, sent
    # The leader ingests the other ranks' manifests; each non-leader
    # receives only control traffic and the broadcast decisions.
    assert received[0] > 2 * min(sent[1:]), (sent, received)
    for r in received[1:]:
        assert r < received[0] / 3, received
        assert r < min(sent[1:]), received
