"""Randomized interop fuzz of the port's bridge: a port, case for case, of
the JAX package's ``tests/test_interop_fuzz.py`` (random nested app
states of mixed dtypes, containers, primitives and hostile keys, seeded
so failures replay), read by the port's reader. The two reference cases
save with the actual reference library and skip without it; added here,
the same trees through the port's own writer, and the 0-d bf16
diagnosis on a hand-built empty blob. ``_rand_tree`` is the JAX file's,
copied (this module imports no jax)."""

import json
import string
from collections import OrderedDict

import numpy as np
import pytest
import torch

from interop_utils import import_reference
from torchsnapshot_tpu_torch.tricks.torchsnapshot_reader import read_reference_snapshot
from torchsnapshot_tpu_torch.tricks.torchsnapshot_writer import write_reference_snapshot


def _rand_key(rng) -> object:
    kind = rng.integers(0, 4)
    if kind == 0:
        return int(rng.integers(-50, 50))
    chars = string.ascii_lowercase + "/%. -"
    return "".join(rng.choice(list(chars)) for _ in range(int(rng.integers(1, 8))))


def _rand_leaf(rng):
    kind = int(rng.integers(0, 8))
    if kind == 0:
        return int(rng.integers(-(2**40), 2**40))
    if kind == 1:
        return float(rng.standard_normal())
    if kind == 2:
        return bool(rng.integers(0, 2))
    if kind == 3:
        return "".join(rng.choice(list(string.printable[:60])) for _ in range(5))
    if kind == 4:
        return bytes(rng.integers(0, 256, int(rng.integers(0, 9)), dtype=np.uint8))
    shape = tuple(int(d) for d in rng.integers(1, 5, size=int(rng.integers(0, 3))))
    tdtype = [torch.float32, torch.bfloat16, torch.int64, torch.float16][int(rng.integers(0, 4))]
    if tdtype == torch.bfloat16 and shape == ():
        # The reference destroys 0-d bf16 at save time (an empty blob).
        tdtype = torch.float32
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(tdtype)


def _rand_tree(rng, depth: int):
    if depth <= 0 or rng.integers(0, 3) == 0:
        return _rand_leaf(rng)
    kind = int(rng.integers(0, 3))
    n = int(rng.integers(1, 5))
    if kind == 0:
        return [_rand_tree(rng, depth - 1) for _ in range(n)]
    cls = OrderedDict if kind == 1 else dict
    out = cls()
    for _ in range(n):
        out[_rand_key(rng)] = _rand_tree(rng, depth - 1)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _compare(ours, theirs, path="") -> None:
    if isinstance(theirs, torch.Tensor):
        assert isinstance(ours, torch.Tensor) and ours.dtype == theirs.dtype, path
        assert ours.shape == theirs.shape, path
        assert torch.equal(_bits(ours), _bits(theirs)), path
        return
    if isinstance(theirs, dict):
        assert type(ours) is type(theirs), path
        assert list(ours.keys()) == list(theirs.keys()), path
        for k in theirs:
            _compare(ours[k], theirs[k], f"{path}/{k!r}")
        return
    if isinstance(theirs, list):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _compare(a, b, f"{path}/{i}")
        return
    assert ours == theirs, f"{path}: {ours!r} != {theirs!r}"


def test_zero_dim_bf16_reference_bug_is_diagnosed(tmp_path):
    """The reference writes an EMPTY blob for 0-d bfloat16 tensors and
    cannot restore them itself; the reader must name that bug."""
    torchsnapshot = import_reference()
    snap = str(tmp_path / "zd")
    torchsnapshot.Snapshot.take(snap, {"s": torchsnapshot.StateDict(z=torch.tensor(1.5, dtype=torch.bfloat16))})
    with pytest.raises(ValueError, match="known reference bug"):
        read_reference_snapshot(snap, device="cpu")


def test_zero_dim_bf16_empty_blob_is_diagnosed(tmp_path):
    """The same diagnosis on the reference's on-disk form, hand-built."""
    (tmp_path / "0" / "s").mkdir(parents=True)
    (tmp_path / "0" / "s" / "z").write_bytes(b"")
    (tmp_path / ".snapshot_metadata").write_text(json.dumps({"version": "0.0.3", "world_size": 1, "manifest": {
        "0/s": {"type": "dict", "keys": ["z"]},
        "0/s/z": {"type": "Tensor", "location": "0/s/z", "serializer": "buffer_protocol",
                  "dtype": "torch.bfloat16", "shape": [], "replicated": False, "byte_range": None},
    }}))
    with pytest.raises(ValueError, match="known reference bug"):
        read_reference_snapshot(str(tmp_path), device="cpu")


@pytest.mark.parametrize("seed", range(8))
def test_reference_fuzz_roundtrip(tmp_path, seed):
    torchsnapshot = import_reference()
    rng = np.random.default_rng(1000 + seed)
    tree = {"root": _rand_tree(rng, depth=3)}
    snap = str(tmp_path / f"fuzz{seed}")
    torchsnapshot.Snapshot.take(snap, {"s": torchsnapshot.StateDict(**tree)})
    _compare(read_reference_snapshot(snap, device="cpu")["s"]["root"], tree["root"])


@pytest.mark.parametrize("seed", range(8))
def test_port_writer_fuzz_roundtrip(tmp_path, seed):
    rng = np.random.default_rng(1000 + seed)
    tree = {"root": _rand_tree(rng, depth=3)}
    snap = str(tmp_path / f"fuzz{seed}")
    write_reference_snapshot(snap, {"s": tree})
    _compare(read_reference_snapshot(snap, device="cpu")["s"]["root"], tree["root"])
