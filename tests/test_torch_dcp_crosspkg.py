"""``tricks/dcp.py`` against the JAX package: the JAX package restores
what ``SnapshotStorageWriter`` wrote; ``SnapshotStorageReader`` serves
JAX-package snapshots (one sharded over the 8 virtual CPU devices among
them) into torch tensors; and a state migrated from DCP by the port and
the same state taken by the JAX package agree entry by entry, blob by blob
and in their CRC tables. Inputs are numpy arrays made from a seed.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from torchsnapshot_tpu_torch.serialization import tensor_as_memoryview, tensor_from_numpy
from torchsnapshot_tpu_torch.tricks.dcp import SnapshotStorageReader, SnapshotStorageWriter, migrate_dcp_to_snapshot

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:torch.distributed is disabled")


def numpy_state(seed: int = 0) -> dict:
    import ml_dtypes

    rng = np.random.default_rng(seed)
    return {
        "model": {
            "0.weight": rng.standard_normal((6, 4)).astype(np.float32),
            "emb.table": rng.standard_normal((16, 8)).astype(ml_dtypes.bfloat16),
            "ids": rng.integers(-9, 9, (5,)).astype(np.int32),
        },
        "opt": {
            "state": {"0.weight": {"exp_avg": rng.standard_normal((6, 4)).astype(np.float32)}},
            "param_groups": [{"lr": 0.001, "params": ["0.weight"]}],
        },
        "step": 9,
    }


def torch_state(tree):
    if isinstance(tree, np.ndarray):
        return tensor_from_numpy(tree).clone()
    if isinstance(tree, dict):
        return {k: torch_state(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [torch_state(v) for v in tree]
    return tree


def assert_equal_to_numpy(expected, got, where="state") -> None:
    if isinstance(expected, np.ndarray):
        if isinstance(got, torch.Tensor):
            got_bytes = bytes(tensor_as_memoryview(got.contiguous()))
        else:
            got_bytes = np.ascontiguousarray(np.asarray(got)).tobytes()
        assert tuple(got.shape) == expected.shape and got_bytes == expected.tobytes(), where
    elif isinstance(expected, dict):
        assert set(expected) == set(got), (where, list(got))
        for k, v in expected.items():
            assert_equal_to_numpy(v, got[k], f"{where}.{k}")
    elif isinstance(expected, list):
        assert len(expected) == len(got), where
        for i, (a, b) in enumerate(zip(expected, got)):
            assert_equal_to_numpy(a, b, f"{where}.{i}")
    else:
        assert expected == got, (where, expected, got)


class _Raw:
    value = None

    def state_dict(self):
        return {}

    def load_state_dict(self, sd):
        self.value = sd


def test_jax_package_restores_what_the_writer_wrote(tmp_path) -> None:
    import torchsnapshot_tpu as jts

    state = numpy_state(1)
    path = str(tmp_path / "snap")
    dcp.save({"train": torch_state(state)}, storage_writer=SnapshotStorageWriter(path))
    raw = _Raw()
    jts.Snapshot(path).restore({"train": raw})
    assert_equal_to_numpy(state, raw.value)
    report = jts.verify_snapshot(path, deep=True)
    assert report.ok and report.crcs_verified > 0, report.problems


def test_reader_serves_jax_package_snapshots(tmp_path) -> None:
    """A JAX take of dense leaves and of an array sharded ``P('x')`` over
    the 8 virtual CPU devices, loaded through the reader into torch."""
    import jax
    import jax.numpy as jnp
    import torchsnapshot_tpu as jts
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    state = numpy_state(2)
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    rows = np.arange(64 * 6, dtype=np.float32).reshape(64, 6) * 0.25
    sharded = jax.device_put(jnp.asarray(rows), NamedSharding(mesh, P("x")))
    path = str(tmp_path / "jax")
    jts.Snapshot.take(path, {"train": jts.PyTreeState(dict(state, rows=sharded))})
    manifest = jts.Snapshot(path).get_manifest()
    assert manifest["0/train/rows"].type == "ShardedArray" and len(manifest["0/train/rows"].shards) == 8

    dest = torch_state(state)
    dest = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else v) for k, v in dest.items()}
    dest["model"] = {k: torch.zeros_like(v) for k, v in dest["model"].items()}
    dest["opt"]["state"]["0.weight"]["exp_avg"] = torch.zeros(6, 4)
    dest["step"] = 0
    dest["rows"] = torch.zeros(64, 6)
    full = {"train": dest}
    dcp.load(full, storage_reader=SnapshotStorageReader(path))
    assert_equal_to_numpy(dict(state, rows=rows), full["train"])


def _manifest(path: str) -> dict:
    with open(os.path.join(path, ".snapshot_metadata")) as f:
        return json.load(f)["manifest"]


def _blobs(path: str) -> dict:
    out = {}
    for f in glob.glob(os.path.join(path, "**", "*"), recursive=True):
        rel = os.path.relpath(f, path)
        if os.path.isfile(f) and not rel.startswith(".") and "/." not in rel:
            with open(f, "rb") as fh:
                out[rel] = fh.read()
    return out


def test_migrated_state_equals_the_jax_packages_take(tmp_path) -> None:
    import torchsnapshot_tpu as jts

    state = numpy_state(3)
    src = str(tmp_path / "dcp")
    dcp.save(torch_state(state), storage_writer=dcp.FileSystemWriter(src))
    port = str(tmp_path / "port")
    migrate_dcp_to_snapshot(src, port, key="state")
    jpath = str(tmp_path / "jax")
    jts.Snapshot.take(jpath, {"state": jts.PyTreeState(state)}, replicated=["state/*"])

    pm, jm = _manifest(port), _manifest(jpath)
    assert sorted(pm) == sorted(jm)
    for key in jm:
        assert pm[key] == jm[key], key
    pb, jb = _blobs(port), _blobs(jpath)
    assert sorted(pb) == sorted(jb)
    for rel in jb:
        assert pb[rel] == jb[rel], rel
