"""The port's manifest schema: JSON round trips, the YAML the JAX package
commits, per-rank availability rules and the helpers the manager's GC
uses.

Port of the JAX package's ``tests/test_manifest.py``. The port commits
metadata as JSON (a YAML subset) and reads either form, so the YAML round
trip is held across the packages: the JAX package's ``to_yaml`` output
loads in the port unchanged, and the port's JSON loads in the JAX package.
The entries compare equal field by field (no tolerance).
"""

import copy

import pytest

from torchsnapshot_tpu import manifest as jmanifest
from torchsnapshot_tpu_torch import manifest as port_manifest
from torchsnapshot_tpu_torch.manifest import (
    ChunkedArrayEntry,
    DictEntry,
    ListEntry,
    ObjectEntry,
    OrderedDictEntry,
    PrimitiveEntry,
    Shard,
    ShardedArrayEntry,
    SnapshotMetadata,
    entry_locations,
    get_manifest_for_rank,
    is_container_entry,
    is_replicated,
)


def _array(location: str, replicated: bool = False, byte_range=None, m=port_manifest):
    return m.ArrayEntry(
        location=location,
        serializer="buffer_protocol",
        dtype="float32",
        shape=[4, 4],
        replicated=replicated,
        byte_range=byte_range,
    )


def _sample_metadata(g=port_manifest) -> SnapshotMetadata:
    """The JAX test's sample, built from the entry classes of manifest
    module ``g`` (the port's by default)."""

    def a(location: str, **kw):
        return _array(location, m=g, **kw)

    manifest = {
        "0/model": g.DictEntry(keys=["weight", "bias", "stats", "step", "lr", "name"]),
        "0/model/weight": a("replicated/model/weight", replicated=True),
        "0/model/bias": a("0/model/bias"),
        "0/model/stats": g.ObjectEntry(
            location="0/model/stats", serializer="pickle", obj_type="dict", replicated=False
        ),
        "0/model/step": g.PrimitiveEntry.from_object(123),
        "0/model/lr": g.PrimitiveEntry.from_object(0.1),
        "0/model/name": g.PrimitiveEntry.from_object("net"),
        "0/sharded": g.ShardedArrayEntry(
            dtype="float32",
            shape=[8, 4],
            shards=[g.Shard(offsets=[0, 0], sizes=[4, 4], array=a("sharded/s/0"))],
        ),
        "0/big": g.ChunkedArrayEntry(
            dtype="float32",
            shape=[8, 4],
            chunks=[
                g.Shard(offsets=[0, 0], sizes=[4, 4], array=a("0/big/chunk_0")),
                g.Shard(offsets=[4, 0], sizes=[4, 4], array=a("0/big/chunk_1")),
            ],
            replicated=False,
        ),
        "0/misc": g.ListEntry(),
        "0/misc/0": g.PrimitiveEntry.from_object(True),
        "0/od": g.OrderedDictEntry(keys=["k"]),
        "0/od/k": g.PrimitiveEntry.from_object(b"\x00\x01"),
        "1/model": g.DictEntry(keys=["weight", "bias"]),
        "1/model/weight": a("replicated/model/weight", replicated=True),
        "1/model/bias": a("1/model/bias"),
        "1/sharded": g.ShardedArrayEntry(
            dtype="float32",
            shape=[8, 4],
            shards=[g.Shard(offsets=[4, 0], sizes=[4, 4], array=a("sharded/s/1"))],
        ),
    }
    return g.SnapshotMetadata(version="0.1.0", world_size=2, manifest=manifest)


def test_json_roundtrip() -> None:
    md = _sample_metadata()
    assert SnapshotMetadata.from_yaml(md.to_json()) == md


def test_yaml_of_the_jax_package_loads() -> None:
    """The JAX package commits YAML; the port reads it into the same
    entries, and the JAX package reads the port's JSON."""
    jmd = _sample_metadata(jmanifest)
    assert SnapshotMetadata.from_yaml(jmd.to_yaml()) == _sample_metadata()
    assert jmanifest.SnapshotMetadata.from_yaml(_sample_metadata().to_json()) == jmd


def test_primitive_values_exact() -> None:
    for value in [0, -17, True, False, "str", b"\xff\x00", 0.1, 1e-300, -0.0]:
        out = PrimitiveEntry.from_object(value).get_value()
        assert type(out) is type(value)
        assert out == value
    text = SnapshotMetadata(
        version="0", world_size=1, manifest={"0/x": PrimitiveEntry.from_object(0.1)}
    ).to_json()
    assert SnapshotMetadata.from_yaml(text).manifest["0/x"].get_value() == 0.1


def test_unknown_entry_type_raises() -> None:
    text = _sample_metadata().to_json().replace('"type": "Array"', '"type": "Cube"', 1)
    assert '"Cube"' in text
    with pytest.raises(ValueError):
        SnapshotMetadata.from_yaml(text)


def test_get_manifest_for_rank_rules() -> None:
    md = _sample_metadata()
    m0 = get_manifest_for_rank(md, 0)
    m1 = get_manifest_for_rank(md, 1)
    # Per-rank entries stay with their owner.
    assert "model/bias" in m0 and m0["model/bias"].location == "0/model/bias"
    assert "model/bias" in m1 and m1["model/bias"].location == "1/model/bias"
    assert "big" in m0 and "big" not in m1
    assert "misc" in m0 and "misc" not in m1
    # Replicated entries are available everywhere.
    assert m0["model/weight"].replicated and m1["model/weight"].replicated
    # Sharded entries merge across ranks and are available everywhere.
    for m in (m0, m1):
        assert [s.offsets for s in m["sharded"].shards] == [[0, 0], [4, 0]]


def test_get_manifest_for_rank_beyond_world_size() -> None:
    md = _sample_metadata()
    m5 = get_manifest_for_rank(md, 5)
    assert "model/weight" in m5
    assert "model" in m5  # ancestor container grafted
    assert "model/bias" not in m5
    assert [s.offsets for s in m5["sharded"].shards] == [[0, 0], [4, 0]]


def test_graft_does_not_mutate_global_manifest() -> None:
    md = _sample_metadata()
    before = copy.deepcopy(md)
    get_manifest_for_rank(md, 5)
    get_manifest_for_rank(md, 1)
    assert md == before


def test_helpers() -> None:
    assert is_container_entry(ListEntry())
    assert is_container_entry(DictEntry(keys=[]))
    assert not is_container_entry(_array("x"))
    assert is_replicated(_array("x", replicated=True))
    assert not is_replicated(ListEntry())


def test_byte_range_tuple() -> None:
    assert _array("x").byte_range_tuple is None
    assert _array("x", byte_range=[3, 9]).byte_range_tuple == (3, 9)


def test_graft_preserves_int_dict_keys() -> None:
    md = SnapshotMetadata(
        version="0",
        world_size=2,
        manifest={
            "0/layers": DictEntry(keys=[0]),
            "0/layers/0": _array("replicated/layers/0", replicated=True),
        },
    )
    assert get_manifest_for_rank(md, 1)["layers"].keys == [0]


def test_entry_locations_match_the_jax_package() -> None:
    """The manager's GC walk: the same locations as the JAX package's, per
    entry kind (containers and primitives name none)."""
    port, jax = _sample_metadata().manifest, _sample_metadata(jmanifest).manifest
    assert {p: entry_locations(e) for p, e in port.items()} == {
        p: jmanifest.entry_locations(e) for p, e in jax.items()
    }
    assert entry_locations(port["0/big"]) == ["0/big/chunk_0", "0/big/chunk_1"]
    assert entry_locations(port["0/sharded"]) == ["sharded/s/0"]
    assert entry_locations(port["0/model/stats"]) == ["0/model/stats"]
    assert entry_locations(port["0/model/step"]) == []
    assert isinstance(port["0/big"], ChunkedArrayEntry)
    assert isinstance(port["0/sharded"], ShardedArrayEntry)
    assert isinstance(port["0/od"], OrderedDictEntry)
    assert isinstance(port["0/model/stats"], ObjectEntry)
    assert isinstance(port["0/big"].chunks[0], Shard)
