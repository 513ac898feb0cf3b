"""The migration bridge across the two packages, held at 0 tolerance
(bytes):

- the reference format: the JAX writer's output read by the port's
  reader, and the port writer's output read by the JAX reader, over the
  eight fuzz trees of ``tests/test_interop_fuzz.py`` (its ``_rand_tree``),
  built without the reference library;
- the int8 codecs: each package's encodings are the other's bytes and
  decode the same with either codec, for f32, f16 and bf16 inputs, per
  tensor and per channel on axes 0, 1 and -1, and for constant, zero and
  empty arrays;
- ``convert``: one hand-built four-rank source converted by both packages
  gives the same entries and digests, and each package restores the
  other's converted snapshot;
- ``TorchStateful``: a snapshot taken through one package's class
  restores through the other's.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from test_interop_fuzz import _compare as jax_compare
from test_interop_fuzz import _rand_tree
from torchsnapshot_tpu import lowp as jlowp
from torchsnapshot_tpu.tricks.convert import convert as jax_convert
from torchsnapshot_tpu.tricks.torch import TorchStateful as JaxTorchStateful
from torchsnapshot_tpu.tricks.torchsnapshot_reader import read_reference_snapshot as jax_read
from torchsnapshot_tpu.tricks.torchsnapshot_writer import write_reference_snapshot as jax_write
from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
from torchsnapshot_tpu_torch import lowp as plowp
from torchsnapshot_tpu_torch.serialization import tensor_from_numpy
from torchsnapshot_tpu_torch.test_utils import write_sharded_reference_snapshot
from torchsnapshot_tpu_torch.tricks.convert import convert as port_convert
from torchsnapshot_tpu_torch.tricks.torch import TorchStateful
from torchsnapshot_tpu_torch.tricks.torchsnapshot_reader import read_reference_snapshot as port_read
from torchsnapshot_tpu_torch.tricks.torchsnapshot_writer import write_reference_snapshot as port_write


def _to_numpy(obj):
    """A torch tree as the JAX writer takes it: tensors as numpy arrays
    (bf16 through ml_dtypes), containers kept."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.bfloat16:
            return obj.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return obj.numpy()
    if isinstance(obj, dict):
        return type(obj)((k, _to_numpy(v)) for k, v in obj.items())
    if isinstance(obj, list):
        return [_to_numpy(v) for v in obj]
    return obj


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _port_compare(ours, theirs, path="") -> None:
    """The port reader's tree against the torch tree the JAX writer wrote.
    The JAX writer records a 0-d array as shape [1] (its
    ``np.ascontiguousarray``, ``torchsnapshot_tpu/tricks/torchsnapshot_writer.py:171``);
    the port's reader returns what the entry says."""
    if isinstance(theirs, torch.Tensor):
        assert isinstance(ours, torch.Tensor) and ours.dtype == theirs.dtype, path
        assert ours.shape == (theirs.shape or (1,)) and _bits(ours) == _bits(theirs), path
        return
    if isinstance(theirs, dict):
        assert type(ours) is type(theirs) and list(ours) == list(theirs), path
        for k in theirs:
            _port_compare(ours[k], theirs[k], f"{path}/{k!r}")
        return
    if isinstance(theirs, list):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _port_compare(a, b, f"{path}/{i}")
        return
    assert ours == theirs, f"{path}: {ours!r} != {theirs!r}"


@pytest.mark.parametrize("seed", range(8))
def test_jax_writer_read_by_port_reader(tmp_path, seed):
    tree = {"root": _rand_tree(np.random.default_rng(1000 + seed), torch, depth=3)}
    jax_write(str(tmp_path / "s"), {"s": _to_numpy(tree)})
    _port_compare(port_read(str(tmp_path / "s"), device="cpu")["s"]["root"], tree["root"])


@pytest.mark.parametrize("seed", range(8))
def test_port_writer_read_by_jax_reader(tmp_path, seed):
    tree = {"root": _rand_tree(np.random.default_rng(1000 + seed), torch, depth=3)}
    port_write(str(tmp_path / "s"), {"s": tree})
    jax_compare(jax_read(str(tmp_path / "s"))["s"]["root"], tree["root"], torch)


# ---------------------------------------------------------------------------
# lowp
# ---------------------------------------------------------------------------

_NP_DTYPES = {"float32": np.float32, "float16": np.float16, "bfloat16": ml_dtypes.bfloat16}


def _array(kind: str, dtype: str) -> np.ndarray:
    rng = np.random.default_rng(abs(hash((kind, dtype))) % 2**32)
    if kind == "random":
        arr = rng.standard_normal((17, 9, 5)) * (10.0 ** rng.uniform(-3, 3, size=(17, 1, 1)))
    elif kind == "constant":
        arr = np.full((6, 4), 2.5)
    elif kind == "zero":
        arr = np.zeros((6, 4))
    else:
        arr = np.zeros((0, 4))
    return arr.astype(_NP_DTYPES[dtype])


def _same_decodes(buf: bytes, shape, jax_decode, port_decode) -> None:
    a = jax_decode(buf, shape)
    b = port_decode(buf, shape, device="cpu")
    assert a.dtype == np.float32 and b.dtype == torch.float32
    assert a.tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("dtype", sorted(_NP_DTYPES))
@pytest.mark.parametrize("codec", ["tensor", "channel0", "channel1", "channel-1"])
def test_lowp_encodings_are_identical(dtype, codec):
    arr = _array("random", dtype)
    t = tensor_from_numpy(arr)
    if codec == "tensor":
        ours, theirs = plowp.encode_per_tensor(t), jlowp.encode_per_tensor(arr)
        decoders = (jlowp.decode_per_tensor, plowp.decode_per_tensor)
    else:
        axis = int(codec[len("channel"):])
        ours, theirs = plowp.encode_per_channel(t, axis), jlowp.encode_per_channel(arr, axis)
        decoders = (jlowp.decode_per_channel, plowp.decode_per_channel)
    assert ours == theirs
    _same_decodes(ours, arr.shape, *decoders)


@pytest.mark.parametrize("dtype", sorted(_NP_DTYPES))
@pytest.mark.parametrize("kind", ["constant", "zero", "empty"])
def test_lowp_degenerate_arrays_are_identical(dtype, kind):
    arr = _array(kind, dtype)
    t = tensor_from_numpy(arr)
    ours = plowp.encode_per_tensor(t)
    assert ours == jlowp.encode_per_tensor(arr)
    _same_decodes(ours, arr.shape, jlowp.decode_per_tensor, plowp.decode_per_tensor)
    ours = plowp.encode_per_channel(t, 0) if arr.shape[0] else None
    if ours is not None:
        assert ours == jlowp.encode_per_channel(arr, 0)
        _same_decodes(ours, arr.shape, jlowp.decode_per_channel, plowp.decode_per_channel)


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------


def _source_state() -> dict:
    rng = np.random.default_rng(5)
    return {
        "model": {
            "w": torch.from_numpy(rng.standard_normal((10, 6)).astype(np.float32)).to(torch.bfloat16),
            "u": torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
            "big": torch.arange(300, dtype=torch.int64),
            "s": torch.tensor(2.5),
        },
        "opt": {"step": 3, "lr": 0.001, "name": "adamw", "flags": [True, False]},
    }


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert_cross")
    write_sharded_reference_snapshot(str(root / "src"), _source_state(), world_size=4, slab_max_bytes=64)
    jax_convert(str(root / "src"), str(root / "jax"))
    port_convert(str(root / "src"), str(root / "port"), device="cpu")
    return root


def _manifest(path) -> dict:
    with open(path / ".snapshot_metadata") as f:
        return json.load(f)


def test_convert_gives_the_same_entries_and_digests(converted):
    j, p = _manifest(converted / "jax"), _manifest(converted / "port")
    assert (j["version"], j["world_size"]) == (p["version"], p["world_size"])
    assert j["manifest"] == p["manifest"]
    digests = [e.get("digest") for e in p["manifest"].values() if e["type"] == "Array"]
    assert len(digests) == 5 and all(digests)


def _zeros_like_state(make):
    state = _source_state()
    return {
        "model": {k: make(torch.zeros_like(v)) for k, v in state["model"].items()},
        "opt": {"step": 0, "lr": 0.0, "name": "", "flags": [False, False]},
    }


def test_jax_restores_the_port_conversion(converted):
    dest = {k: jts.PyTreeState(v) for k, v in _zeros_like_state(_to_numpy).items()}
    jts.Snapshot(str(converted / "port")).restore(dest)
    want = _source_state()
    for k, v in want["model"].items():
        got = np.asarray(dest["model"].tree[k])
        assert got.tobytes() == _bits(v), k
    assert dest["opt"].tree == want["opt"]


def test_port_restores_the_jax_conversion(converted):
    dest = {k: TensorTreeState(v) for k, v in _zeros_like_state(lambda t: t).items()}
    Snapshot(str(converted / "jax")).restore(dest)
    want = _source_state()
    for k, v in want["model"].items():
        assert _bits(dest["model"].tree[k]) == _bits(v), k
    assert dest["opt"].tree == want["opt"]


# ---------------------------------------------------------------------------
# TorchStateful
# ---------------------------------------------------------------------------


def _model(seed: int) -> torch.nn.Module:
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))


def _trained(seed: int):
    model = _model(seed)
    optim = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.randn(4, 8)).sum().backward()
    optim.step()
    return model, optim


def _same_torch_state(a, b) -> None:
    (ma, oa), (mb, ob) = a, b
    for (k, x), (_, y) in zip(ma.state_dict().items(), mb.state_dict().items()):
        assert _bits(x) == _bits(y), k
    sa, sb = oa.state_dict(), ob.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for pid, fields in sa["state"].items():
        for name, x in fields.items():
            assert _bits(x) == _bits(sb["state"][pid][name]), (pid, name)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_torch_stateful_across_packages(tmp_path, direction):
    src = _trained(7)
    dst = _trained(8)
    take_cls, restore_cls = (JaxTorchStateful, TorchStateful) if direction == "jax_to_port" else (TorchStateful, JaxTorchStateful)
    take = jts.Snapshot.take if direction == "jax_to_port" else Snapshot.take
    snapshot = Snapshot if direction == "jax_to_port" else jts.Snapshot
    take(str(tmp_path), {"model": take_cls(src[0]), "optim": take_cls(src[1])})
    snapshot(str(tmp_path)).restore({"model": restore_cls(dst[0]), "optim": restore_cls(dst[1])})
    _same_torch_state(src, dst)
