"""Reference-snapshot -> native-snapshot conversion in the port
(``torchsnapshot_tpu_torch/tricks/convert.py``): a port, case for case, of
the JAX package's ``tests/test_convert.py`` on the CPU (``--device cpu``).

After conversion the native feature set applies: the converted snapshot
restores, passes the deep fsck and chains as an incremental base.
"""

import numpy as np
import pytest
import torch
import yaml

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
from torchsnapshot_tpu_torch.fsck import verify_snapshot
from torchsnapshot_tpu_torch.tricks.convert import convert, main, verify_source
from torchsnapshot_tpu_torch.tricks.torchsnapshot_reader import ReferenceSnapshotReader
from torchsnapshot_tpu_torch.tricks.torchsnapshot_writer import write_reference_snapshot


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def _reference_snapshot(path) -> dict:
    state = {
        "model": {
            "w": torch.from_numpy(np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)),
            "emb": torch.arange(16, dtype=torch.float32).to(torch.bfloat16),
        },
        "progress": {"step": 7, "tag": "run-a"},
    }
    write_reference_snapshot(str(path), state)
    return state


def test_convert_then_native_restore_and_fsck(tmp_path):
    src = tmp_path / "old"
    dst = tmp_path / "new"
    state = _reference_snapshot(src)

    assert main([str(src), str(dst), "--verify", "--device", "cpu"]) == 0

    dest = {
        "model": TensorTreeState({"w": torch.zeros(8, 4), "emb": torch.zeros(16, dtype=torch.bfloat16)}),
        "progress": TensorTreeState({"step": 0, "tag": ""}),
    }
    Snapshot(str(dst)).restore(dest)
    assert torch.equal(dest["model"].tree["w"], state["model"]["w"])
    assert _bits(dest["model"].tree["emb"]) == _bits(state["model"]["emb"])
    assert dest["progress"].tree["step"] == 7
    assert dest["progress"].tree["tag"] == "run-a"

    assert not verify_snapshot(str(dst), deep=True).problems

    # The converted snapshot is a valid incremental base: an unchanged
    # next take chains off it and rewrites (next to) nothing.
    nxt = tmp_path / "next"
    Snapshot.take(
        str(nxt),
        {
            "model": TensorTreeState({"w": state["model"]["w"].clone(), "emb": state["model"]["emb"].clone()}),
            "progress": TensorTreeState({"step": 7, "tag": "run-a"}),
        },
        incremental_base=str(dst),
    )
    assert not verify_snapshot(str(nxt), deep=True).problems
    # Chained entries use parent-ref locations into the base snapshot:
    # their presence proves the converted snapshot's digests made chunks
    # skippable.
    assert "../" in (nxt / ".snapshot_metadata").read_text(), "next take did not chain off the converted base"


def test_verify_catches_missing_and_truncated_blobs(tmp_path):
    src = tmp_path / "old"
    _reference_snapshot(src)
    w_blob = src / "0" / "model" / "w"
    w_blob.write_bytes(w_blob.read_bytes()[:10])
    (src / "0" / "model" / "emb").unlink()

    reader = ReferenceSnapshotReader(str(src), device="cpu")
    problems = verify_source(reader, rank=0)
    reader.close()
    assert any("missing blob" in p for p in problems)
    assert any("bytes" in p and "w" in p for p in problems)

    # The CLI fails fast and leaves no destination commit marker.
    dst = tmp_path / "new"
    assert main([str(src), str(dst), "--verify", "--device", "cpu"]) == 1
    assert not (dst / ".snapshot_metadata").exists()


def test_dropped_rank_warning(tmp_path, capsys):
    """A multi-rank source with per-rank private state: converting rank
    0's view warns that other ranks' entries are not carried."""
    src = tmp_path / "old"
    _reference_snapshot(src)
    meta_path = src / ".snapshot_metadata"
    doc = yaml.safe_load(meta_path.read_text())
    doc["world_size"] = 2
    blob = np.ones(4, np.float32)
    (src / "1" / "opt").mkdir(parents=True)
    (src / "1" / "opt" / "m").write_bytes(blob.tobytes())
    doc["manifest"]["1/opt"] = {"type": "dict", "keys": ["m"]}
    doc["manifest"]["1/opt/m"] = {
        "type": "Tensor", "location": "1/opt/m", "serializer": "buffer_protocol",
        "dtype": "torch.float32", "shape": [4], "replicated": False, "byte_range": None,
    }
    meta_path.write_text(yaml.safe_dump(doc, sort_keys=False))

    dst = tmp_path / "new"
    assert main([str(src), str(dst), "--verify", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "WARNING" in err and "rank 1" in err and "opt/m" in err
    # Converting rank 1 instead carries its private state and warns about
    # rank 0's.
    dst1 = tmp_path / "new_rank1"
    assert main([str(src), str(dst1), "--rank", "1", "--device", "cpu"]) == 0
    assert "rank 0" in capsys.readouterr().err
    dest = {"opt": TensorTreeState({"m": torch.zeros(4)})}
    Snapshot(str(dst1)).restore(dest)
    np.testing.assert_array_equal(dest["opt"].tree["m"].numpy(), blob)


def test_convert_without_verify_still_fails_cleanly(tmp_path):
    src = tmp_path / "old"
    _reference_snapshot(src)
    (src / "0" / "model" / "w").unlink()
    dst = tmp_path / "new"
    with pytest.raises(FileNotFoundError):
        convert(str(src), str(dst), device="cpu")
    assert not (dst / ".snapshot_metadata").exists()


def test_verify_reports_unreadable_blobs_instead_of_crashing(tmp_path):
    """Backend errors that are neither FileNotFoundError nor the
    normalized OSError(EIO) truncation contract must land in the problem
    list, not crash verify_source."""
    src = tmp_path / "old"
    _reference_snapshot(src)

    class _Boom(Exception):
        pass

    reader = ReferenceSnapshotReader(str(src), device="cpu")
    try:
        reader.metadata  # the manifest loads; only blob probes explode

        def _raise(location, byte_range):
            raise _Boom("backend exploded")

        reader._read_blob = _raise
        problems = verify_source(reader, rank=0)
    finally:
        reader.close()
    assert problems
    assert all("unreadable" in p and "_Boom" in p for p in problems)


def test_cli_reads_onto_the_card_by_default(tmp_path, capsys):
    """The CLI reads onto the card by default; without one it fails and
    says how to ask for the CPU, leaving no destination."""
    src = tmp_path / "old"
    _reference_snapshot(src)
    if torch.cuda.is_available():
        assert main([str(src), str(tmp_path / "new")]) == 0
        assert (tmp_path / "new" / ".snapshot_metadata").exists()
        return
    assert main([str(src), str(tmp_path / "new")]) == 1
    assert "device='cpu'" in capsys.readouterr().err
    assert not (tmp_path / "new" / ".snapshot_metadata").exists()
