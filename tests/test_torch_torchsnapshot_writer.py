"""Writing reference-format snapshots with the port
(``torchsnapshot_tpu_torch/tricks/torchsnapshot_writer.py``): a port, case
for case, of the JAX package's ``tests/test_torchsnapshot_writer.py`` on
the CPU. Added: the metadata is JSON that PyYAML reads to the same
document, and a multi-rank ``DTensor`` is refused by name (a one-rank one
is written whole)."""

from collections import OrderedDict

import numpy as np
import pytest
import torch
import yaml

from interop_utils import import_reference
from torchsnapshot_tpu_torch.tricks.torchsnapshot_reader import read_reference_snapshot
from torchsnapshot_tpu_torch.tricks.torchsnapshot_writer import metadata_text, write_reference_snapshot


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def _state():
    g = torch.Generator().manual_seed(0)
    return {
        "model": {
            "w": torch.randn(8, 4, generator=g),
            "emb": torch.randn(16, generator=g).to(torch.bfloat16),
            "ids": torch.arange(6, dtype=torch.int32),
            "od": OrderedDict(b=2, a=1),
            "lst": [1.25, "x", torch.ones(3, dtype=torch.float64)],
        },
        "progress": {"step": 7, "done": False, "tag": b"\x01\x02"},
    }


def test_roundtrip_through_own_reader(tmp_path):
    state = _state()
    snap = str(tmp_path / "snap")
    write_reference_snapshot(snap, state)
    back = read_reference_snapshot(snap, device="cpu")
    assert torch.equal(back["model"]["w"], state["model"]["w"])
    assert back["model"]["emb"].dtype == torch.bfloat16
    assert _bits(back["model"]["emb"]) == _bits(state["model"]["emb"])
    assert torch.equal(back["model"]["ids"], torch.arange(6, dtype=torch.int32))
    assert isinstance(back["model"]["od"], OrderedDict)
    assert list(back["model"]["od"].items()) == [("b", 2), ("a", 1)]
    assert back["model"]["lst"][0] == 1.25
    assert back["model"]["lst"][1] == "x"
    assert torch.equal(back["model"]["lst"][2], torch.ones(3, dtype=torch.float64))
    assert back["progress"] == {"step": 7, "done": False, "tag": b"\x01\x02"}
    # The metadata is JSON, and PyYAML reads the same document.
    text = (tmp_path / "snap" / ".snapshot_metadata").read_text()
    assert yaml.safe_load(text) == __import__("json").loads(text)


def test_bridge_over_non_fs_url():
    """The bridge rides the storage-plugin URL grammar: write and read a
    reference-format snapshot through the in-memory plugin."""
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

    url = "memory://ref_bridge_roundtrip_port"
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    try:
        write_reference_snapshot(url, {"m": {"w": w}})
        assert torch.equal(read_reference_snapshot(url, device="cpu")["m"]["w"], w)
    finally:
        MemoryStoragePlugin.drop_store("ref_bridge_roundtrip_port")


@pytest.mark.parametrize(
    "leaf",
    [torch.zeros(2, dtype=torch.uint32), torch.zeros(2, dtype=torch.float8_e4m3fn), np.zeros(2, dtype=np.uint64)],
    ids=["uint32", "float8_e4m3fn", "numpy-uint64"],
)
def test_unrepresentable_dtype_rejected(tmp_path, leaf):
    with pytest.raises(ValueError, match="cast to a supported dtype"):
        write_reference_snapshot(str(tmp_path / "bad"), {"s": {"x": leaf}})
    assert not (tmp_path / "bad" / ".snapshot_metadata").exists()


def test_reference_library_restores_our_snapshot(tmp_path):
    torchsnapshot = import_reference()
    state = _state()
    snap = str(tmp_path / "export")
    write_reference_snapshot(snap, state)

    dest = {
        "model": torchsnapshot.StateDict(
            w=torch.zeros(8, 4),
            emb=torch.zeros(16, dtype=torch.bfloat16),
            ids=torch.zeros(6, dtype=torch.int32),
            od=OrderedDict(b=0, a=0),
            lst=[0.0, "", torch.zeros(3, dtype=torch.float64)],
        ),
        "progress": torchsnapshot.StateDict(step=0, done=True, tag=b""),
    }
    torchsnapshot.Snapshot(snap).restore(dest)
    assert torch.equal(dest["model"]["w"], state["model"]["w"])
    assert _bits(dest["model"]["emb"]) == _bits(state["model"]["emb"])
    assert torch.equal(dest["model"]["ids"], torch.arange(6, dtype=torch.int32))
    assert dict(dest["model"]["od"]) == {"b": 2, "a": 1}
    assert dest["model"]["lst"][0] == 1.25
    assert dest["model"]["lst"][1] == "x"
    assert torch.equal(dest["model"]["lst"][2], torch.ones(3, dtype=torch.float64))
    assert dest["progress"]["step"] == 7
    assert dest["progress"]["done"] is False
    assert dest["progress"]["tag"] == b"\x01\x02"


def test_reference_library_reads_complex_and_objects(tmp_path):
    torchsnapshot = import_reference()
    opaque = {(1, 2): "x", (3, 4): "y"}
    cplx = torch.complex(torch.arange(4.0), torch.arange(4.0))
    snap = str(tmp_path / "cplx")
    write_reference_snapshot(snap, {"s": {"z": cplx, "o": opaque}})
    dest = {"s": torchsnapshot.StateDict(z=torch.zeros(4, dtype=torch.complex64), o={})}
    torchsnapshot.Snapshot(snap).restore(dest)
    assert torch.equal(dest["s"]["z"], cplx)
    assert dest["s"]["o"] == opaque


def test_big_endian_arrays_normalized_before_serialization(tmp_path):
    """A '>f4' numpy array (dtype.name is still 'float32') must round-trip
    value-exact: the reference format is raw LITTLE-endian bytes."""
    big = np.arange(12, dtype=np.float32).astype(">f4").reshape(3, 4)
    big_i = np.array([1, -2, 3], dtype=">i8")
    snap = str(tmp_path / "snap")
    write_reference_snapshot(snap, {"m": {"w": big, "i": big_i}})
    back = read_reference_snapshot(snap, device="cpu")
    np.testing.assert_array_equal(back["m"]["w"].numpy(), big.astype("<f4"))
    np.testing.assert_array_equal(back["m"]["i"].numpy(), big_i.astype("<i8"))
    assert float(back["m"]["w"][1, 2]) == 6.0  # not byte-swapped garbage


def test_big_endian_complex_normalized_on_torch_save_path(tmp_path):
    big_c = (np.arange(4) + 1j * np.arange(4)).astype(">c8")
    snap = str(tmp_path / "snapc")
    write_reference_snapshot(snap, {"m": {"c": big_c}})
    back = read_reference_snapshot(snap, device="cpu")
    np.testing.assert_array_equal(back["m"]["c"].numpy(), big_c.astype("<c8"))


def test_metadata_json_is_the_same_yaml_document():
    """Keys a YAML 1.1 parser would fold or refuse (NEL, line and
    paragraph separators, C1 controls, BOM) and astral characters give
    the same document through ``json.loads`` and ``yaml.safe_load``."""
    import json

    keys = ["a\x85b", "l s", "p s", "c\x9f", "d\x7f", "b﻿", "e\U0001F600", "tab\there", 'q"\\']
    doc = {"version": "0.0.3", "world_size": 1, "manifest": {f"0/{k}": {"type": "dict", "keys": [k, 7]} for k in keys}}
    text = metadata_text(doc)
    assert json.loads(text) == doc
    assert yaml.safe_load(text) == doc


def test_dtensor_leaves(tmp_path):
    """A DTensor on a one-rank mesh is written as its full tensor; one over
    more ranks is refused by name (the writer is world size 1)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from torchsnapshot_tpu_torch.test_utils import get_free_port

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{get_free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        full = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        dt = DTensor.from_local(full.clone(), mesh, [Shard(0)], run_check=False)
        write_reference_snapshot(str(tmp_path / "one"), {"m": {"w": dt}})
        assert torch.equal(read_reference_snapshot(str(tmp_path / "one"), device="cpu")["m"]["w"], full)

        class _TwoRanks:
            def size(self):
                return 2

        fake = DTensor.from_local(full.clone(), mesh, [Replicate()], run_check=False)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(DTensor, "device_mesh", property(lambda self: _TwoRanks()))
            with pytest.raises(ValueError, match="DTensor over 2 ranks"):
                write_reference_snapshot(str(tmp_path / "two"), {"m": {"w": fake}})
    finally:
        dist.destroy_process_group()
