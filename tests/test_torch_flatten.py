"""The port's flatten / inflate: round trips, including hostile keys.

Port of the JAX package's ``tests/test_flatten.py``, with torch tensors as
the array leaves, plus the cross-package check that both packages flatten
one tree to the same manifest paths and leaves (the logical paths of
every snapshot depend on it). Compared exactly.
"""

from collections import OrderedDict

import pytest
import torch

from torchsnapshot_tpu import flatten as jflatten
from torchsnapshot_tpu_torch.flatten import _decode, _encode, flatten, inflate


def _roundtrip(obj, prefix="my/prefix"):
    manifest, flattened = flatten(obj, prefix=prefix)
    return manifest, flattened, inflate(manifest, flattened, prefix=prefix)


def test_docstring_example() -> None:
    collection = {"foo": [1, 2, OrderedDict(bar=3, baz=4)]}
    manifest, flattened = flatten(collection, prefix="my/prefix")
    assert set(manifest.keys()) == {
        "my%2Fprefix",
        "my%2Fprefix/foo",
        "my%2Fprefix/foo/2",
    }
    assert manifest["my%2Fprefix"].type == "dict"
    assert manifest["my%2Fprefix/foo"].type == "list"
    assert manifest["my%2Fprefix/foo/2"].type == "OrderedDict"
    assert manifest["my%2Fprefix/foo/2"].keys == ["bar", "baz"]
    assert flattened == {
        "my%2Fprefix/foo/0": 1,
        "my%2Fprefix/foo/1": 2,
        "my%2Fprefix/foo/2/bar": 3,
        "my%2Fprefix/foo/2/baz": 4,
    }
    assert inflate(manifest, flattened, prefix="my/prefix") == collection


def test_nested_roundtrip() -> None:
    obj = {
        "a": [1, "two", 3.0, [4, {"five": 6}]],
        "b": OrderedDict(x={"deep": {"deeper": [None, True]}}, y=b"bytes"),
        7: "int key",
        "empty_list": [],
        "empty_dict": {},
    }
    _, _, out = _roundtrip(obj)
    assert out == obj
    assert type(out["b"]) is OrderedDict
    assert 7 in out  # int key recovered as int


def test_key_collision_keeps_dict_opaque() -> None:
    obj = {"outer": {1: "int one", "1": "str one"}}
    manifest, flattened, out = _roundtrip(obj)
    # The colliding dict must be kept as a single opaque leaf.
    assert "my%2Fprefix/outer" in flattened
    assert out == obj


def test_non_str_int_keys_keep_dict_opaque() -> None:
    obj = {"outer": {(1, 2): "tuple key"}}
    manifest, flattened, out = _roundtrip(obj)
    assert flattened["my%2Fprefix/outer"] == {(1, 2): "tuple key"}
    assert out == obj


def test_slash_and_percent_in_keys() -> None:
    obj = {"a/b": {"c%d": 1, "e%2Ff": 2, "%": 3}}
    _, flattened, out = _roundtrip(obj)
    assert out == obj
    # No raw slash from user keys may survive in path components beyond
    # hierarchy separators.
    for path in flattened:
        assert "a/b" not in path


def test_list_subclass_and_dict_subclass_are_leaves() -> None:
    class MyList(list):
        pass

    class MyDict(dict):
        pass

    obj = {"l": MyList([1, 2]), "d": MyDict(a=1)}
    _, flattened, out = _roundtrip(obj)
    assert isinstance(out["l"], MyList)
    assert isinstance(out["d"], MyDict)
    assert out == obj


def test_negative_int_keys() -> None:
    obj = {"d": {-3: "neg", "+4": "plus-string-stays-str-if-no-collision"}}
    _, _, out = _roundtrip(obj)
    # -3 parses back to int; "+4" parses to int 4 only if absent from keys —
    # here "+4" was the original key so it must be preserved.
    assert -3 in out["d"]
    assert "+4" in out["d"]


def test_array_leaves_pass_through_identically() -> None:
    arr = torch.arange(6).reshape(2, 3)
    obj = {"w": arr}
    _, flattened, out = _roundtrip(obj)
    assert out["w"] is arr


def test_non_flattenable_root() -> None:
    manifest, flattened = flatten(42, prefix="x")
    assert manifest == {}
    assert flattened == {"x": 42}
    assert inflate(manifest, flattened, prefix="x") == 42


def test_inflate_missing_prefix_raises() -> None:
    with pytest.raises(AssertionError):
        inflate({}, {}, prefix="nope")


def test_encode_decode_inverse() -> None:
    for s in ["plain", "a/b", "a%2Fb", "%", "%25", "a%b/c%2F", ""]:
        assert _decode(_encode(s)) == s


def test_order_preserved() -> None:
    obj = {"z": 1, "a": 2, "m": 3}
    _, _, out = _roundtrip(obj)
    assert list(out.keys()) == ["z", "a", "m"]


def test_bool_keyed_dict_stays_opaque() -> None:
    """Regression: bool keys can't survive path stringification; the dict
    must be kept as an opaque leaf (review finding)."""
    obj = {"outer": {True: "x", False: "y"}}
    manifest, flattened = flatten(obj, prefix="p")
    assert "p/outer" in flattened
    assert inflate(manifest, flattened, prefix="p") == obj


@pytest.mark.parametrize(
    "obj",
    [
        {"foo": [1, 2, OrderedDict(bar=3, baz=4)]},
        {"a/b": {"c%d": 1, "e%2Ff": 2, "%": 3}, 7: "int key", "e": [], "f": {}},
        {"outer": {1: "int one", "1": "str one"}, "d": {-3: "neg", "+4": "plus"}},
        {"outer": {True: "x", False: "y"}, "t": {(1, 2): "tuple key"}},
    ],
)
def test_same_paths_as_the_jax_package(obj) -> None:
    port_manifest, port_flat = flatten(obj, prefix="0/app")
    jax_manifest, jax_flat = jflatten.flatten(obj, prefix="0/app")
    assert port_flat == jax_flat
    assert {p: (e.type, getattr(e, "keys", None)) for p, e in port_manifest.items()} == {
        p: (e.type, getattr(e, "keys", None)) for p, e in jax_manifest.items()
    }
