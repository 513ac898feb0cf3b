"""Incremental takes of the port: unchanged chunks become base refs (no
bytes staged or written), changed chunks are rewritten, restores stay
byte-exact; checksum inheritance, chained bases and the fall-backs to a full
take. Ports of the ``pg=None`` cases of the JAX package's
``tests/test_incremental.py``, plus digest identity across the two packages
in both directions: a base written by either feeds the other's incremental
take with no rewrite of unchanged leaves. Sharded (``DTensor``) leaves on
two gloo ranks: unchanged pieces become refs, a changed mesh rewrites, and
the pieces' digests equal the JAX package's for the same boxes.
Everything is compared bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.tricks.torch import TorchStateful
from torchsnapshot_tpu_torch import Snapshot, StateDict, TensorTreeState, knobs
from torchsnapshot_tpu_torch import io_preparer
from torchsnapshot_tpu_torch.incremental import relative_ref_prefix
from torchsnapshot_tpu_torch.integrity import ChecksumError
from torchsnapshot_tpu_torch.manifest import ArrayEntry, ChunkedArrayEntry
from torchsnapshot_tpu_torch.models import transformer as tt

torch.set_num_threads(1)


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _blob_files(root: str) -> set:
    """Data blobs under a snapshot dir (metadata and checksum tables
    excluded)."""
    out = set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            if not rel.startswith((".snapshot_metadata", "checksums")):
                out.add(rel)
    return out


def _take_pair(tmp_path, state0, state1, **kwargs):
    p0, p1 = str(tmp_path / "step_0"), str(tmp_path / "step_1")
    Snapshot.take(p0, state0, record_digests=True)
    Snapshot.take(p1, state1, incremental_base=p0, **kwargs)
    return p0, p1


def _tree(**tensors):
    return {"m": TensorTreeState(dict(tensors))}


def test_relative_ref_prefix(tmp_path, monkeypatch) -> None:
    assert relative_ref_prefix("/r/step_1", "/r/step_0") == "../step_0"
    assert relative_ref_prefix("/r/step_1", "memory://step_0") is None
    assert relative_ref_prefix("/r/a", "/r/a") is None
    monkeypatch.chdir(tmp_path)
    want = relative_ref_prefix(str(tmp_path / "r" / "step_1"), str(tmp_path / "r" / "step_0"))
    assert want == "../step_0"
    assert relative_ref_prefix("r/step_1", str(tmp_path / "r" / "step_0")) == want
    assert relative_ref_prefix("r/step_1", "r/step_0") == want
    assert relative_ref_prefix("/", str(tmp_path / "r")) is None


def test_dense_unchanged_is_not_rewritten(tmp_path) -> None:
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    b = torch.ones(8)
    p0, p1 = _take_pair(tmp_path, _tree(w=w, b=b), _tree(w=w.clone(), b=b + 1))
    files1 = _blob_files(p1)
    assert "0/m/b" in files1 and "0/m/w" not in files1, files1
    w_entry = Snapshot(p1).get_manifest()["0/m/w"]
    assert isinstance(w_entry, ArrayEntry)
    assert w_entry.location == "../step_0/0/m/w"
    assert w_entry.digest is not None
    dest = {"w": torch.zeros(8, 8), "b": torch.zeros(8)}
    Snapshot(p1).restore({"m": TensorTreeState(dest)})
    assert _bytes(dest["w"]) == _bytes(w) and _bytes(dest["b"]) == _bytes(b + 1)


def test_unchanged_leaf_gets_no_stager(tmp_path, monkeypatch) -> None:
    """An unchanged leaf's bytes never reach a stager (on the card: never
    cross to the host)."""
    state = _tree(w=torch.arange(1024, dtype=torch.float32))
    p0 = str(tmp_path / "s0")
    Snapshot.take(p0, state, record_digests=True)
    calls = []
    orig = io_preparer.ArrayBufferStager.__init__

    def counting_init(self, *a, **k):
        calls.append(1)
        orig(self, *a, **k)

    monkeypatch.setattr(io_preparer.ArrayBufferStager, "__init__", counting_init)
    Snapshot.take(str(tmp_path / "s1"), state, incremental_base=p0)
    assert calls == []


def test_chunked_partial_change(tmp_path) -> None:
    base = torch.arange(32 * 8, dtype=torch.float32).reshape(32, 8)
    changed = base.clone()
    changed[20, 3] += 1.0
    with knobs.override_max_chunk_size_bytes(256):  # 8 rows a chunk
        p0, p1 = _take_pair(tmp_path, _tree(big=base), _tree(big=changed))
    entry = Snapshot(p1).get_manifest()["0/m/big"]
    assert isinstance(entry, ChunkedArrayEntry)
    new = [c for c in entry.chunks if not c.array.location.startswith("../")]
    assert len(new) == 1 and new[0].offsets[0] <= 20 < new[0].offsets[0] + new[0].sizes[0]
    assert len(entry.chunks) == 4
    dest = {"big": torch.zeros(32, 8)}
    Snapshot(p1).restore({"m": TensorTreeState(dest)})
    assert _bytes(dest["big"]) == _bytes(changed)


def test_chained_refs_collapse_to_origin(tmp_path) -> None:
    w = torch.arange(32, dtype=torch.float32)
    p0, p1, p2 = (str(tmp_path / f"step_{i}") for i in range(3))
    Snapshot.take(p0, _tree(w=w), record_digests=True)
    Snapshot.take(p1, _tree(w=w), incremental_base=p0)
    Snapshot.take(p2, _tree(w=w), incremental_base=p1)
    assert Snapshot(p2).get_manifest()["0/m/w"].location == "../step_0/0/m/w"
    dest = {"w": torch.zeros(32)}
    Snapshot(p2).restore({"m": TensorTreeState(dest)})
    assert _bytes(dest["w"]) == _bytes(w)


def test_checksum_inheritance_detects_base_corruption(tmp_path) -> None:
    w = torch.arange(64, dtype=torch.float32)
    p0, p1 = _take_pair(tmp_path, _tree(w=w), _tree(w=w.clone()))
    with open(os.path.join(p0, "0", "m", "w"), "r+b") as f:
        f.seek(8)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(ChecksumError):
        Snapshot(p1).restore({"m": TensorTreeState({"w": torch.zeros(64)})})


def test_digests_recorded_only_on_request(tmp_path) -> None:
    Snapshot.take(str(tmp_path / "d"), _tree(w=torch.ones(8)), record_digests=True)
    assert Snapshot(str(tmp_path / "d")).get_manifest()["0/m/w"].digest.startswith("mlh64:")
    Snapshot.take(str(tmp_path / "n"), _tree(w=torch.ones(8)))
    assert Snapshot(str(tmp_path / "n")).get_manifest()["0/m/w"].digest is None


@pytest.mark.parametrize("base", ["no_digests", "missing"])
def test_unusable_base_falls_back_to_full(tmp_path, base) -> None:
    w = torch.arange(16, dtype=torch.float32)
    p0 = str(tmp_path / "s0")
    if base == "no_digests":
        Snapshot.take(p0, _tree(w=w))
    p1 = str(tmp_path / "s1")
    Snapshot.take(p1, _tree(w=w), incremental_base=p0)
    entry = Snapshot(p1).get_manifest()["0/m/w"]
    assert not entry.location.startswith("../") and entry.digest is not None
    dest = {"w": torch.zeros(16)}
    Snapshot(p1).restore({"m": TensorTreeState(dest)})
    assert _bytes(dest["w"]) == _bytes(w)


def test_dtype_change_forces_rewrite(tmp_path) -> None:
    """Same bytes, another dtype: no ref."""
    p0, p1 = _take_pair(
        tmp_path, _tree(x=torch.zeros(16, dtype=torch.float32)),
        _tree(x=torch.zeros(16, dtype=torch.int32)),
    )
    assert not Snapshot(p1).get_manifest()["0/m/x"].location.startswith("../")


def test_chunk_knob_change_forces_rewrite(tmp_path) -> None:
    base = torch.arange(32 * 8, dtype=torch.float32).reshape(32, 8)
    p0, p1 = str(tmp_path / "s0"), str(tmp_path / "s1")
    with knobs.override_max_chunk_size_bytes(256):
        Snapshot.take(p0, _tree(big=base), record_digests=True)
    with knobs.override_max_chunk_size_bytes(512):
        Snapshot.take(p1, _tree(big=base), incremental_base=p0)
    entry = Snapshot(p1).get_manifest()["0/m/big"]
    assert all(not c.array.location.startswith("../") for c in entry.chunks)
    dest = {"big": torch.zeros(32, 8)}
    Snapshot(p1).restore({"m": TensorTreeState(dest)})
    assert _bytes(dest["big"]) == _bytes(base)


def test_incremental_chunk_knob_refines_skip_unit(tmp_path) -> None:
    base = torch.from_numpy(np.random.default_rng(0).standard_normal((256, 16)).astype(np.float32))
    changed = base.clone()
    changed[100] += 1.0
    with knobs.override_incremental_chunk_size_bytes(1024):  # 16 rows a chunk
        p0, p1 = _take_pair(tmp_path, _tree(t=base), _tree(t=changed))
        entry = Snapshot(p1).get_manifest()["0/m/t"]
        assert isinstance(entry, ChunkedArrayEntry)
        new = [c for c in entry.chunks if not c.array.location.startswith("../")]
        assert len(new) == 1 and len(entry.chunks) == 16
        # Without digests the knob leaves the layout alone.
        Snapshot.take(str(tmp_path / "plain"), _tree(t=base))
        assert isinstance(Snapshot(str(tmp_path / "plain")).get_manifest()["0/m/t"], ArrayEntry)


def test_incremental_async_take(tmp_path) -> None:
    w = torch.arange(64, dtype=torch.float32)
    b = torch.ones(8)
    p0 = str(tmp_path / "s0")
    Snapshot.take(p0, _tree(w=w, b=b), record_digests=True)
    snap = Snapshot.async_take(
        str(tmp_path / "s1"), _tree(w=w.clone(), b=b * 3), incremental_base=p0
    ).wait()
    assert snap.get_manifest()["0/m/w"].location == "../s0/0/m/w"
    dest = {"w": torch.zeros(64), "b": torch.zeros(8)}
    snap.restore({"m": TensorTreeState(dest)})
    assert _bytes(dest["w"]) == _bytes(w) and _bytes(dest["b"]) == _bytes(b * 3)


def test_read_object_through_ref(tmp_path) -> None:
    w = torch.arange(16, dtype=torch.float32)
    _, p1 = _take_pair(tmp_path, _tree(w=w), _tree(w=w.clone()))
    assert _bytes(Snapshot(p1).read_object("0/m/w")) == _bytes(w)


def test_host_numpy_and_object_leaves(tmp_path) -> None:
    """Numpy leaves are digested on the host; objects and primitives are
    always written."""
    w = np.arange(24, dtype=np.float32)
    p0, p1 = _take_pair(
        tmp_path,
        {"m": StateDict(w=w.copy(), v=np.zeros(4, np.int32), meta=1 + 2j, n=3)},
        {"m": StateDict(w=w.copy(), v=np.ones(4, np.int32), meta=1 + 2j, n=3)},
    )
    manifest = Snapshot(p1).get_manifest()
    assert manifest["0/m/w"].location.startswith("../")
    assert not manifest["0/m/v"].location.startswith("../")
    assert not manifest["0/m/meta"].location.startswith("../")
    dest = {"m": StateDict(w=np.zeros_like(w), v=np.zeros(4, np.int32), meta=None, n=0)}
    Snapshot(p1).restore(dest)
    np.testing.assert_array_equal(dest["m"]["w"], w)
    np.testing.assert_array_equal(dest["m"]["v"], np.ones(4, np.int32))
    assert dest["m"]["meta"] == 1 + 2j and dest["m"]["n"] == 3


def test_memory_scheme_refuses_refs() -> None:
    w = torch.arange(16, dtype=torch.float32)
    Snapshot.take("memory://port-incr-s0", _tree(w=w), record_digests=True)
    Snapshot.take("memory://port-incr-s1", _tree(w=w), incremental_base="memory://port-incr-s0")
    assert not Snapshot("memory://port-incr-s1").get_manifest()["0/m/w"].location.startswith("../")
    dest = {"w": torch.zeros(16)}
    Snapshot("memory://port-incr-s1").restore({"m": TensorTreeState(dest)})
    assert _bytes(dest["w"]) == _bytes(w)


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------


def _model_pair(seed: int):
    cfg = tt.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=256, attn_impl="flash"
    )
    return tt.init_train_state(cfg, seed=seed, device="cpu").model


def _refs(manifest) -> dict:
    """logical path -> True when the leaf (every chunk of it) is a ref."""
    out = {}
    for path, e in manifest.items():
        if type(e).__name__ == "ArrayEntry":
            out[path] = e.location.startswith("../")
        elif type(e).__name__ == "ChunkedArrayEntry":
            out[path] = all(c.array.location.startswith("../") for c in e.chunks)
    return out


def _touch_first_layer(model) -> str:
    with torch.no_grad():
        model.layers[0].wo.add_(1.0)
    return "0/model/layers.0.wo"


def test_jax_base_feeds_the_port_incremental_take(tmp_path) -> None:
    model = _model_pair(0)
    p0, p1 = str(tmp_path / "jax_0"), str(tmp_path / "port_1")
    with jknobs.override_incremental_chunk_size_bytes(16 * 1024), knobs.override_incremental_chunk_size_bytes(16 * 1024):
        jts.Snapshot.take(p0, {"model": TorchStateful(model)}, record_digests=True)
        changed = _touch_first_layer(model)
        Snapshot.take(p1, {"model": model}, incremental_base=p0)
    refs = _refs(Snapshot(p1).get_manifest())
    assert refs.pop(changed) is False
    assert refs and all(refs.values()), refs
    assert any(
        isinstance(e, ChunkedArrayEntry) for e in Snapshot(p1).get_manifest().values()
    )
    fresh = _model_pair(1)
    Snapshot(p1).restore({"model": fresh})
    for (n, a), (_, b) in zip(model.named_parameters(), fresh.named_parameters()):
        assert _bytes(a) == _bytes(b), n


def test_port_base_feeds_the_jax_incremental_take(tmp_path) -> None:
    model = _model_pair(0)
    p0, p1 = str(tmp_path / "port_0"), str(tmp_path / "jax_1")
    with jknobs.override_incremental_chunk_size_bytes(16 * 1024), knobs.override_incremental_chunk_size_bytes(16 * 1024):
        Snapshot.take(p0, {"model": model}, record_digests=True)
        jts.Snapshot.take(str(tmp_path / "jax_0"), {"model": TorchStateful(model)}, record_digests=True)
        changed = _touch_first_layer(model)
        jts.Snapshot.take(p1, {"model": TorchStateful(model)}, incremental_base=p0)
    # Both packages record the same digest for every chunk of the base.
    port_base = Snapshot(p0).get_manifest()
    jax_base = jts.Snapshot(str(tmp_path / "jax_0")).get_manifest()

    def digests(manifest):
        out = {}
        for path, e in manifest.items():
            if type(e).__name__ == "ArrayEntry":
                out[path] = [e.digest]
            elif type(e).__name__ == "ChunkedArrayEntry":
                out[path] = [c.array.digest for c in e.chunks]
        return out

    assert digests(port_base) == digests(jax_base) and digests(port_base)
    refs = _refs(jts.Snapshot(p1).get_manifest())
    assert refs.pop(changed) is False
    assert refs and all(refs.values()), refs
    fresh = _model_pair(1)
    Snapshot(p1).restore({"model": fresh})
    for (n, a), (_, b) in zip(model.named_parameters(), fresh.named_parameters()):
        assert _bytes(a) == _bytes(b), n


# ---------------------------------------------------------------------------
# Sharded (DTensor) leaves, two ranks on gloo CPU meshes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded_incremental(tmp_path_factory):
    from test_torch_resharding import sharded_incremental_worker
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    root = str(tmp_path_factory.mktemp("sharded_incr"))
    return root, run_multiprocess(sharded_incremental_worker, 2, args=(root,))


def test_sharded_unchanged_pieces_are_refs(sharded_incremental) -> None:
    """Only the piece that holds the changed row is rewritten; every other
    piece of both ranks (the uneven leaf's too) references the base."""
    from test_torch_resharding import _entry_fields

    root, results = sharded_incremental
    assert all(r["incr"] for r in results)
    pieces = _entry_fields(os.path.join(root, "incr"), "m/w") + _entry_fields(
        os.path.join(root, "incr"), "m/u"
    )
    rewritten = [p for p in pieces if not p[2].startswith("../")]
    assert [p[:2] for p in rewritten] == [((32, 0), (16, 16))]
    assert rewritten[0][2] == "sharded/m/w_32_0"
    assert len(pieces) == 4 + 2 * len(range(0, 501, 32))  # 16-row pieces of 501 and 500 rows
    assert _blob_files(os.path.join(root, "incr")) == {"sharded/m/w_32_0"}


def test_sharded_changed_mesh_rewrites(sharded_incremental) -> None:
    """Column boxes match none of the base's row boxes: all rewritten."""
    from test_torch_resharding import _entry_fields

    root, results = sharded_incremental
    assert all(r["moved"] for r in results)
    pieces = _entry_fields(os.path.join(root, "moved"), "m/w") + _entry_fields(
        os.path.join(root, "moved"), "m/u"
    )
    assert pieces and not any(p[2].startswith("../") for p in pieces)
    assert all(p[3].startswith("mlh64:") for p in pieces)


def test_sharded_piece_digests_equal_the_jax_package(sharded_incremental, tmp_path) -> None:
    """The same arrays on the JAX package's 2-device mesh, cut by the same
    knob into the same pieces, record the same digests at the same
    locations."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from test_torch_resharding import INCR_CHUNK, _entry_fields, seeded

    root, _ = sharded_incremental
    sharding = NamedSharding(Mesh(np.array(jax.devices()[:2]), ("x",)), P("x"))
    w = jax.device_put(jnp.asarray(seeded((64, 16), 1).numpy()), sharding)
    # 1001 rows do not divide over 2 devices; the 1000-row prefix does not
    # either cut like torch, so only the even leaf is compared.
    with jknobs.override_incremental_chunk_size_bytes(INCR_CHUNK):
        jts.Snapshot.take(str(tmp_path / "j"), {"m": jts.PyTreeState({"w": w})}, record_digests=True)
    from torchsnapshot_tpu.manifest import get_manifest_for_rank

    jentry = get_manifest_for_rank(jts.Snapshot(str(tmp_path / "j")).metadata, 0)["m/w"]
    jfields = sorted((tuple(s.offsets), tuple(s.sizes), s.array.location, s.array.digest) for s in jentry.shards)
    assert jfields == _entry_fields(os.path.join(root, "base"), "m/w")


def test_sharded_deep_fsck_follows_refs(sharded_incremental, tmp_path) -> None:
    """The deep fsck of the incremental sharded snapshot verifies its own
    shard blobs and, through the refs, the base's; a flipped byte in a
    referenced base shard is caught (on a copy of both snapshots)."""
    import shutil

    from torchsnapshot_tpu_torch.fsck import verify_snapshot

    root, _ = sharded_incremental
    assert verify_snapshot(os.path.join(root, "incr"), deep=True).ok
    copy = tmp_path / "copy"
    shutil.copytree(os.path.join(root, "base"), copy / "base")
    shutil.copytree(os.path.join(root, "incr"), copy / "incr")
    victim = copy / "base" / "sharded" / "m" / "w_0_0"  # referenced by incr
    data = bytearray(victim.read_bytes())
    data[5] ^= 0x01
    victim.write_bytes(bytes(data))
    report = verify_snapshot(str(copy / "incr"), deep=True)
    assert not report.ok
    assert any("w_0_0" in p.location for p in report.problems)
