"""Reading reference-format (TorchSnapshot 0.0.3) snapshots with the port
(``torchsnapshot_tpu_torch/tricks/torchsnapshot_reader.py``): a port, case
for case, of the JAX package's ``tests/test_torchsnapshot_reader.py`` on
the CPU (``device="cpu"``).

- Hand-built fixtures covering the documented schema (reference
  manifest.py:27-290), written from the format spec with YAML metadata,
  as the reference writes it: every entry type, both serializers,
  byte_range slabs, sharded and chunked assembly, the cross-rank
  availability rules.
- Live interop with the actual reference library, skipped when it is
  not importable (``tests/interop_utils.py``).

The JAX case that poisons ``torch`` becomes two: the reader needs neither
``ml_dtypes`` nor, for JSON metadata, PyYAML; YAML metadata without
PyYAML raises an error naming it.
"""

import base64
import io
import json
import os
import struct
import subprocess
import sys
from collections import OrderedDict

import numpy as np
import pytest
import torch
import yaml

from interop_utils import import_reference
from torchsnapshot_tpu_torch.tricks.torchsnapshot_reader import (
    ReferenceSnapshotReader,
    read_reference_snapshot,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(path, data: bytes) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)


def _prim(kind: str, serialized: str, replicated=False) -> dict:
    return {"type": kind, "serialized_value": serialized, "replicated": replicated, "readable": None}


def _tensor_entry(location, dtype, shape, serializer="buffer_protocol", replicated=False, byte_range=None) -> dict:
    return {
        "type": "Tensor",
        "location": location,
        "serializer": serializer,
        "dtype": dtype,
        "shape": list(shape),
        "replicated": replicated,
        "byte_range": byte_range,
    }


def _box(offsets, sizes, tensor: dict) -> dict:
    return {"offsets": list(offsets), "sizes": list(sizes), "tensor": tensor}


def _commit(path, manifest: dict, world_size: int = 1) -> None:
    doc = {"version": "0.0.3", "world_size": world_size, "manifest": manifest}
    (path / ".snapshot_metadata").write_text(yaml.safe_dump(doc, sort_keys=False))


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@pytest.fixture
def hand_built(tmp_path):
    """A world_size-2 snapshot written from the format spec alone."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 4), dtype=np.float32)
    bf16 = torch.from_numpy(rng.standard_normal((8,), dtype=np.float32)).to(torch.bfloat16)
    slab_a = rng.standard_normal((4,), dtype=np.float32)
    slab_b = np.arange(6, dtype=np.int32)
    chunk_full = rng.standard_normal((6, 2), dtype=np.float32)
    shard_full = rng.standard_normal((4, 4), dtype=np.float32)
    repl = np.arange(5, dtype=np.int64)

    _write(tmp_path / "0/app/weights", f32.tobytes())
    _write(tmp_path / "0/app/halfs", _bits(bf16))
    _write(tmp_path / "batched/slab0", slab_a.tobytes() + slab_b.tobytes())
    _write(tmp_path / "0/app/chunked_0_0", chunk_full[:3].tobytes())
    _write(tmp_path / "0/app/chunked_3_0", chunk_full[3:].tobytes())
    _write(tmp_path / "sharded/app/sharded_0", shard_full[:2].tobytes())
    _write(tmp_path / "sharded/app/sharded_1", shard_full[2:].tobytes())
    _write(tmp_path / "replicated/app/ids", repl.tobytes())

    manifest = {
        "0/app": {"type": "dict", "keys": [
            "weights", "halfs", "lst", "od", "n", "pi", "flag", "blob", "name", "chunked", 7,
        ]},
        "0/app/weights": _tensor_entry("0/app/weights", "torch.float32", (3, 4)),
        "0/app/halfs": _tensor_entry("0/app/halfs", "torch.bfloat16", (8,)),
        "0/app/lst": {"type": "list"},
        "0/app/lst/0": _tensor_entry("batched/slab0", "torch.float32", (4,), byte_range=[0, 16]),
        "0/app/lst/1": _tensor_entry("batched/slab0", "torch.int32", (6,), byte_range=[16, 40]),
        "0/app/od": {"type": "OrderedDict", "keys": ["b", "a"]},
        "0/app/od/b": _prim("int", "2"),
        "0/app/od/a": _prim("int", "1"),
        "0/app/n": _prim("int", "-42"),
        "0/app/pi": _prim("float", base64.b64encode(struct.pack("d", 3.14159)).decode()),
        "0/app/flag": _prim("bool", "False"),
        "0/app/blob": _prim("bytes", base64.b64encode(b"\x00\xffhi").decode()),
        "0/app/name": _prim("str", "tpu"),
        "0/app/7": _prim("str", "int-key"),
        "0/app/chunked": {
            "type": "ChunkedTensor",
            "dtype": "torch.float32",
            "shape": [6, 2],
            "replicated": False,
            "chunks": [
                _box((0, 0), (3, 2), _tensor_entry("0/app/chunked_0_0", "torch.float32", (3, 2))),
                _box((3, 0), (3, 2), _tensor_entry("0/app/chunked_3_0", "torch.float32", (3, 2))),
            ],
        },
        # rank 0 holds shard 0, rank 1 shard 1: the reader must merge.
        "0/sh": {"type": "dict", "keys": ["emb"]},
        "0/sh/emb": {"type": "ShardedTensor", "shards": [
            _box((0, 0), (2, 4), _tensor_entry("sharded/app/sharded_0", "torch.float32", (2, 4))),
        ]},
        "1/sh": {"type": "dict", "keys": ["emb"]},
        "1/sh/emb": {"type": "ShardedTensor", "shards": [
            _box((2, 0), (2, 4), _tensor_entry("sharded/app/sharded_1", "torch.float32", (2, 4))),
        ]},
        # replicated entry recorded on rank 0 only (post-partitioning
        # form): available to rank 1 too, container chain included.
        "0/rep": {"type": "dict", "keys": ["ids"]},
        "0/rep/ids": _tensor_entry("replicated/app/ids", "torch.int64", (5,), replicated=True),
    }
    _commit(tmp_path, manifest, world_size=2)
    return tmp_path, {
        "f32": f32, "bf16": bf16, "slab_a": slab_a, "slab_b": slab_b,
        "chunk_full": chunk_full, "shard_full": shard_full, "repl": repl,
    }


def _eq(t: torch.Tensor, arr: np.ndarray) -> None:
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), arr)


def test_read_state_rank0(hand_built):
    path, ref = hand_built
    state = read_reference_snapshot(str(path), rank=0, device="cpu")
    app = state["app"]
    _eq(app["weights"], ref["f32"])
    assert app["halfs"].dtype == torch.bfloat16
    assert _bits(app["halfs"]) == _bits(ref["bf16"])
    _eq(app["lst"][0], ref["slab_a"])
    _eq(app["lst"][1], ref["slab_b"])
    assert isinstance(app["od"], OrderedDict)
    assert list(app["od"].items()) == [("b", 2), ("a", 1)]
    assert app["n"] == -42
    assert app["pi"] == struct.unpack("d", struct.pack("d", 3.14159))[0]
    assert app["flag"] is False
    assert app["blob"] == b"\x00\xffhi"
    assert app["name"] == "tpu"
    assert app[7] == "int-key"
    _eq(app["chunked"], ref["chunk_full"])
    _eq(state["sh"]["emb"], ref["shard_full"])
    _eq(state["rep"]["ids"], ref["repl"])
    # Original dict key order preserved from the recorded keys.
    assert list(app.keys())[:3] == ["weights", "halfs", "lst"]


def test_rank1_sees_replicated_and_merged_sharded(hand_built):
    path, ref = hand_built
    state = read_reference_snapshot(str(path), rank=1, device="cpu")
    _eq(state["sh"]["emb"], ref["shard_full"])
    _eq(state["rep"]["ids"], ref["repl"])
    assert "app" not in state


def test_read_object_paths(hand_built):
    path, ref = hand_built
    reader = ReferenceSnapshotReader(str(path), device="cpu")
    assert reader.world_size == 2
    _eq(reader.read_object("0/app/weights"), ref["f32"])
    _eq(reader.read_object("app/lst/1", rank=0), ref["slab_b"])
    assert reader.read_object("0/app/od/a") == 1
    with pytest.raises(KeyError):
        reader.read_object("0/app/nope")
    reader.close()


def _run_poisoned(code: str, poisoned: str) -> subprocess.CompletedProcess:
    prelude = f"import sys\nsys.modules[{poisoned!r}] = None  # any import of it now raises\n"
    return subprocess.run(
        [sys.executable, "-c", prelude + code],
        capture_output=True,
        text=True,
        timeout=120,
        cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO},
    )


def test_reader_needs_neither_ml_dtypes_nor_pyyaml_for_json(hand_built):
    """The card's machine has no ml_dtypes and may lack PyYAML: a bf16
    snapshot with JSON metadata reads with both poisoned."""
    path, ref = hand_built
    doc = yaml.safe_load((path / ".snapshot_metadata").read_text())
    (path / ".snapshot_metadata").write_text(json.dumps(doc))
    code = f"""
sys.modules["ml_dtypes"] = None
from torchsnapshot_tpu_torch.tricks.torchsnapshot_reader import read_reference_snapshot
state = read_reference_snapshot({str(path)!r}, device="cpu")
assert state["app"]["weights"].shape == (3, 4)
assert str(state["app"]["halfs"].dtype) == "torch.bfloat16"
assert state["app"]["n"] == -42
print("NO-YAML OK")
"""
    proc = _run_poisoned(code, "yaml")
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "NO-YAML OK" in proc.stdout


def test_yaml_metadata_without_pyyaml_names_it(hand_built):
    path, _ = hand_built
    code = f"""
from torchsnapshot_tpu_torch.tricks.torchsnapshot_reader import read_reference_snapshot
try:
    read_reference_snapshot({str(path)!r}, device="cpu")
except RuntimeError as e:
    assert "PyYAML" in str(e), e
    print("NAMED")
"""
    proc = _run_poisoned(code, "yaml")
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "NAMED" in proc.stdout


def test_torch_save_entries(tmp_path):
    t = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    # Plain lists (incl. a list of tuples) inside the pickled object are
    # user data: inflation must not mistake them for its own (index,
    # value) accumulator lists.
    obj = {
        "vals": torch.ones(2, dtype=torch.bfloat16),
        "n": 5,
        "leaf_list": [1, 2, 3],
        "pairs": [(0, "a"), (1, "b")],
        # numpy payloads are rejected by torch>=2.6's weights_only
        # default: the reader must load the user's own checkpoint fully.
        "np_payload": np.arange(3),
    }
    buf = io.BytesIO()
    torch.save(t, buf)
    _write(tmp_path / "0/s/t", buf.getvalue())
    buf = io.BytesIO()
    torch.save(obj, buf)
    _write(tmp_path / "0/s/o", buf.getvalue())
    _commit(tmp_path, {
        "0/s": {"type": "dict", "keys": ["t", "o"]},
        "0/s/t": _tensor_entry("0/s/t", "torch.float64", (3, 4), serializer="torch_save"),
        "0/s/o": {
            "type": "object", "location": "0/s/o", "serializer": "torch_save",
            "obj_type": "dict", "replicated": False,
        },
    })
    state = read_reference_snapshot(str(tmp_path), device="cpu")
    assert torch.equal(state["s"]["t"], t)
    # Tensors inside object entries stay torch tensors (the JAX package
    # gives numpy arrays).
    vals = state["s"]["o"]["vals"]
    assert isinstance(vals, torch.Tensor) and vals.dtype == torch.bfloat16
    assert torch.equal(vals, obj["vals"])
    assert state["s"]["o"]["n"] == 5
    assert state["s"]["o"]["leaf_list"] == [1, 2, 3]
    assert state["s"]["o"]["pairs"] == [(0, "a"), (1, "b")]
    np.testing.assert_array_equal(state["s"]["o"]["np_payload"], np.arange(3))


def test_qtensor_serializer_rejected_with_explanation(tmp_path):
    _write(tmp_path / "0/a/q", b"\x00" * 8)
    _commit(tmp_path, {
        "0/a": {"type": "dict", "keys": ["q"]},
        "0/a/q": _tensor_entry("0/a/q", "torch.float32", (2,), serializer="per_tensor_qtensor"),
    })
    with pytest.raises(NotImplementedError, match="torch_save"):
        read_reference_snapshot(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# Live interop: save with the actual reference library, read with the port.
# ---------------------------------------------------------------------------


def test_reference_library_interop(tmp_path):
    torchsnapshot = import_reference()
    torch.manual_seed(3)
    app_state = {
        "model": torchsnapshot.StateDict(
            w=torch.randn(16, 8),
            halfs=torch.randn(32).to(torch.bfloat16),
            ints=torch.arange(10, dtype=torch.int32),
            nested={"bias": torch.zeros(8), "meta": {"epoch": 4}},
            lst=[1.5, "two", torch.ones(3, dtype=torch.float64)],
            flag=True,
            raw=b"\x01\x02",
        ),
        "progress": torchsnapshot.StateDict(step=17),
    }
    snap_dir = str(tmp_path / "ref_snap")
    torchsnapshot.Snapshot.take(snap_dir, app_state)

    state = read_reference_snapshot(snap_dir, device="cpu")
    model = state["model"]
    assert torch.equal(model["w"], app_state["model"]["w"])
    assert _bits(model["halfs"]) == _bits(app_state["model"]["halfs"])
    assert torch.equal(model["ints"], app_state["model"]["ints"])
    assert torch.equal(model["nested"]["bias"], torch.zeros(8))
    assert model["nested"]["meta"]["epoch"] == 4
    assert model["lst"][0] == 1.5
    assert model["lst"][1] == "two"
    assert torch.equal(model["lst"][2], torch.ones(3, dtype=torch.float64))
    assert model["flag"] is True
    assert model["raw"] == b"\x01\x02"
    assert state["progress"]["step"] == 17


def test_reference_library_interop_hostile_keys(tmp_path):
    """Keys containing the path separator, percent signs, and int keys,
    written by the actual reference library, decoded by the port."""
    torchsnapshot = import_reference()
    hostile = {
        "a/b": torch.ones(2),
        "100%": "percent",
        "%2F": "encoded-looking",
        7: torch.zeros(3),
        "plain": {"x/y%z": 1},
    }
    snap = str(tmp_path / "hostile")
    torchsnapshot.Snapshot.take(snap, {"s": torchsnapshot.StateDict(**{"outer": hostile})})

    outer = read_reference_snapshot(snap, device="cpu")["s"]["outer"]
    assert torch.equal(outer["a/b"], torch.ones(2))
    assert outer["100%"] == "percent"
    assert outer["%2F"] == "encoded-looking"
    assert torch.equal(outer[7], torch.zeros(3))
    assert outer["plain"] == {"x/y%z": 1}


def test_reference_library_interop_real_sharded_tensor(tmp_path):
    """A ShardedTensor written by the actual reference library (saved in a
    subprocess with its own gloo world), assembled by the port's reader
    and placed as a DTensor on a one-rank mesh."""
    reference = import_reference()  # skip early if the reference is unavailable
    root = os.path.dirname(os.path.dirname(reference.__file__))

    snap = str(tmp_path / "sharded_ref")
    code = f"""
import os, sys
sys.path.insert(0, {root!r})
import torch
import torch.distributed as dist
os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
os.environ.setdefault("MASTER_PORT", "29584")
dist.init_process_group("gloo", rank=0, world_size=1)
from torch.distributed._shard import sharded_tensor as st
from torch.distributed._shard.sharding_spec import ChunkShardingSpec
import torchsnapshot
spec = ChunkShardingSpec(dim=0, placements=["rank:0/cpu"])
t = st.zeros(spec, (8, 4))
t.local_shards()[0].tensor.copy_(torch.arange(32, dtype=torch.float32).reshape(8, 4))
torchsnapshot.Snapshot.take({snap!r}, {{"s": torchsnapshot.StateDict(emb=t)}})
dist.destroy_process_group()
print("SAVED")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=180)
    if proc.returncode != 0 or "SAVED" not in proc.stdout:
        pytest.skip(f"reference ShardedTensor save unavailable on this torch: {proc.stderr[-300:]}")

    full = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    assert torch.equal(read_reference_snapshot(snap, device="cpu")["s"]["emb"], full)


def test_reference_library_interop_chunked_and_batched(tmp_path):
    torchsnapshot = import_reference()
    big = torch.randn(1 << 14)  # 64 KiB fp32: chunks at a 16 KiB knob
    small = [torch.randn(16) for _ in range(4)]
    app_state = {"s": torchsnapshot.StateDict(big=big, **{f"small{i}": t for i, t in enumerate(small)})}
    snap_dir = str(tmp_path / "ref_chunked")
    env = {"TORCHSNAPSHOT_MAX_CHUNK_SIZE_BYTES_OVERRIDE": str(1 << 14), "TORCHSNAPSHOT_ENABLE_BATCHING": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        torchsnapshot.Snapshot.take(snap_dir, app_state)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    reader = ReferenceSnapshotReader(snap_dir, device="cpu")
    kinds = {e["type"] for e in reader.metadata["manifest"].values()}
    assert "ChunkedTensor" in kinds, "knob did not force chunking"
    state = reader.read_state()
    assert torch.equal(state["s"]["big"], big)
    for i, t in enumerate(small):
        assert torch.equal(state["s"][f"small{i}"], t)


def test_assemble_raises_on_shard_coverage_holes(tmp_path):
    """A sharded entry with an interior hole must raise, not silently
    zero-fill."""
    full = np.arange(16, dtype=np.float32).reshape(4, 4)
    _write(tmp_path / "s0", full[:1].tobytes())
    _write(tmp_path / "s3", full[3:].tobytes())  # rows 1-2 missing
    _commit(tmp_path, {
        "0/m": {"type": "dict", "keys": ["emb"]},
        "0/m/emb": {"type": "ShardedTensor", "shards": [
            _box((0, 0), (1, 4), _tensor_entry("s0", "torch.float32", (1, 4))),
            _box((3, 0), (1, 4), _tensor_entry("s3", "torch.float32", (1, 4))),
        ]},
    })
    with ReferenceSnapshotReader(str(tmp_path), device="cpu") as reader:
        with pytest.raises(ValueError, match="holes"):
            reader.read_object("0/m/emb")


def test_read_blobs_surfaces_unfilled_buffer_explicitly(tmp_path):
    """A plugin completing read() without populating buf must raise a
    named RuntimeError (an assert would vanish under python -O)."""
    _write(tmp_path / "0/m/w", np.ones(4, dtype=np.float32).tobytes())
    _commit(tmp_path, {
        "0/m": {"type": "dict", "keys": ["w"]},
        "0/m/w": _tensor_entry("0/m/w", "torch.float32", (4,)),
    })

    class _NoFill:
        async def read(self, read_io):
            pass  # never sets read_io.buf

        async def close(self):
            pass

    reader = ReferenceSnapshotReader(str(tmp_path), device="cpu")
    try:
        import asyncio

        reader._loop = asyncio.new_event_loop()
        reader._storage = _NoFill()
        with pytest.raises(RuntimeError, match="_NoFill.*without populating"):
            reader._read_blobs([("0/m/w", None)])
    finally:
        reader.close()


def test_reader_defaults_to_the_card(hand_built):
    """The reader produces tensors, so it targets the card unless the
    caller asks for the CPU; without a card that raises."""
    path, ref = hand_built
    if torch.cuda.is_available():
        assert read_reference_snapshot(str(path))["app"]["weights"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            read_reference_snapshot(str(path))
