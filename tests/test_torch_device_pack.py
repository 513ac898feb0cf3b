"""The port's device pack (``ops/device_pack.py``): the plain version's
bytes against the JAX package's pack and the serializer's, the kernel's
table, and batched snapshots that stage a slab's members through one pack
and one copy to the host.

Port of the JAX package's ``tests/test_device_pack.py``. On the CPU the
wrapper runs the plain version (``torch.cat`` of the members' uint8
views), as the JAX package's pack runs its XLA program on the CPU backend;
the kernel itself is held against it on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``). Deliberate
difference: the JAX package falls back to per-member staging when a pack
fails (its ``test_pack_failure_falls_back`` and
``test_pack_fallback_skips_already_scattered_members``); the port raises,
so the take fails and leaves no commit marker
(``test_pack_failure_fails_the_take``). Its group cap of 128 members per
dispatch (a compile-time bound of the XLA program) has no counterpart: one
kernel launch packs a slab's members of one device, however many.
"""

import asyncio
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
from torchsnapshot_tpu_torch.io_preparer import ArrayBufferStager, DeviceCopier
from torchsnapshot_tpu_torch.io_types import WriteReq
from torchsnapshot_tpu_torch.knobs import (
    enable_batching,
    enable_device_pack,
    override_slab_size_threshold_bytes,
)
from torchsnapshot_tpu_torch.ops import device_pack as dp
from torchsnapshot_tpu_torch.serialization import tensor_as_memoryview
from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_METADATA_FNAME

torch.set_num_threads(1)

DTYPES = [
    "float32", "float16", "bfloat16", "float64", "int8", "uint8", "int16", "int32",
    "int64", "bool", "float8_e4m3fn", "float8_e5m2",
]


def _np_array(shape, dtype: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) > 0.5
    if dtype.startswith(("int", "uint")):
        return rng.integers(-100 if dtype.startswith("int") else 0, 100, shape).astype(dtype)
    x = (rng.standard_normal(shape) * 10).astype(np.float32)
    if dtype in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        import ml_dtypes

        return x.astype(getattr(ml_dtypes, dtype))
    return x.astype(dtype)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    from torchsnapshot_tpu_torch.serialization import tensor_from_numpy

    return tensor_from_numpy(arr).clone()


@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_plain_matches_the_jax_pack_and_the_serializer(dtype) -> None:
    import jax.numpy as jnp

    from torchsnapshot_tpu.ops import device_pack as jdp
    from torchsnapshot_tpu.serialization import array_as_memoryview
    from torchsnapshot_tpu.test_utils import backend_materializes_dtype

    hosts = [_np_array((5, 3), dtype, seed=i) for i in range(3)]
    packed = dp.pack_async([(_tensor(h), None) for h in hosts])
    assert packed.dtype == torch.uint8 and packed.device.type == "cpu"
    expect = b"".join(bytes(array_as_memoryview(h)) for h in hosts)
    assert packed.numpy().tobytes() == expect
    assert packed.numpy().tobytes() == b"".join(
        bytes(tensor_as_memoryview(_tensor(h))) for h in hosts
    )
    # Without x64, jax keeps 64-bit dtypes as 32-bit: no JAX pack to hold.
    if backend_materializes_dtype(dtype) and jnp.asarray(hosts[0]).dtype == hosts[0].dtype:
        theirs = np.asarray(jdp.pack_async([(jnp.asarray(h), None) for h in hosts]))
        assert theirs.tobytes() == packed.numpy().tobytes()


def test_pack_row_slices_match_the_jax_pack() -> None:
    import jax.numpy as jnp

    from torchsnapshot_tpu.ops import device_pack as jdp

    host = _np_array((16, 4), "float32", seed=1)
    specs = [((2, 7)), ((10, 12)), ((0, 0))]
    packed = dp.pack_async([(_tensor(host), s) for s in specs])
    assert packed.numpy().tobytes() == host[2:7].tobytes() + host[10:12].tobytes()
    theirs = np.asarray(jdp.pack_async([(jnp.asarray(host), s) for s in specs[:2]]))
    assert theirs.tobytes() == packed.numpy().tobytes()
    with pytest.raises(ValueError, match="row range"):
        dp.pack_async([(_tensor(host), (3, 17))])


def test_pack_supported_excludes_complex() -> None:
    assert not dp.pack_supported(torch.complex64)
    assert dp.pack_supported(torch.float32) and dp.pack_supported(torch.bool)
    assert not dp.pack_supported(np.float32)  # a torch dtype is expected


def test_kernel_table_layout_and_the_contiguous_copy() -> None:
    """The table the kernel reads: n + 1 slab offsets (empty and 1-byte
    members included), then each member's source address; a member that
    is not contiguous is copied first, and counted."""
    a = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    b = torch.zeros(0)
    c = torch.ones(1, dtype=torch.uint8)
    d = torch.arange(20, dtype=torch.float32).reshape(4, 5)[:, 1::2]  # not contiguous
    dp.reset_launch_counts()
    table, total, members = dp.build_table([(a, (1, 3)), (b, None), (c, None), (d, None)])
    assert dp.copy_counts["device_pack_contiguous"] == 1
    assert total == 2 * 16 + 0 + 1 + 4 * 2 * 4
    assert table[:5].tolist() == [0, 32, 32, 33, total]
    assert table[5] == a.data_ptr() + 16
    assert table[7] == c.data_ptr()
    assert members[3].is_contiguous() and torch.equal(members[3], d)
    assert dp.launch_counts["device_pack"] == 0  # nothing launched on the CPU
    assert dp.pack_plain([(d, None)]).numpy().tobytes() == d.contiguous().numpy().tobytes()


def _spy(monkeypatch) -> list:
    calls = []
    orig = dp.pack_async

    def counting(specs):
        calls.append(len(specs))
        return orig(specs)

    monkeypatch.setattr(dp, "pack_async", counting)
    return calls


def test_batched_snapshot_uses_device_pack(tmp_path, monkeypatch) -> None:
    """With batching and the pack on, a slab's tensor members stage
    through one pack call; the restore is bit-exact."""
    calls = _spy(monkeypatch)
    tree = {f"leaf_{i}": _tensor(_np_array((32, 8), "float32", seed=i)) for i in range(6)}
    tree["obj"] = {"not": "a tensor"}
    p = str(tmp_path / "snap")
    with enable_batching(), enable_device_pack(), override_slab_size_threshold_bytes(1 << 20):
        Snapshot.take(p, {"m": TensorTreeState(tree)})
    assert calls == [6]
    dest = {"m": TensorTreeState({**{k: torch.zeros(32, 8) for k in tree if k != "obj"}, "obj": None})}
    Snapshot(p).restore(dest)
    for k, v in tree.items():
        if k != "obj":
            assert torch.equal(dest["m"].tree[k], v), k
    assert dest["m"].tree["obj"] == tree["obj"]


def test_one_pack_per_slab_however_many_members(tmp_path, monkeypatch) -> None:
    """300 members (over the JAX package's cap of 128 a dispatch) in one
    slab: one pack."""
    calls = _spy(monkeypatch)
    tree = {f"l{i:03d}": torch.full((4,), float(i)) for i in range(300)}
    p = str(tmp_path / "snap")
    with enable_batching(), enable_device_pack():
        Snapshot.take(p, {"m": TensorTreeState(tree)})
    assert calls == [300]
    assert Snapshot(p).read_object("0/m/l123").tolist() == [123.0] * 4


def test_batched_snapshot_mixed_dtypes_roundtrip(tmp_path) -> None:
    tree = {f"a_{dt}": _tensor(_np_array((7, 3), dt, seed=i)) for i, dt in enumerate(DTYPES)}
    p = str(tmp_path / "snap")
    with enable_batching(), enable_device_pack(), override_slab_size_threshold_bytes(1 << 20):
        Snapshot.take(p, {"m": TensorTreeState(tree)})
    dest = {"m": TensorTreeState({k: torch.zeros_like(v) for k, v in tree.items()})}
    Snapshot(p).restore(dest)
    for k, v in tree.items():
        assert bytes(tensor_as_memoryview(dest["m"].tree[k])) == bytes(tensor_as_memoryview(v)), k


def test_pack_failure_fails_the_take(tmp_path, monkeypatch) -> None:
    """No fallback: a failing pack raises out of the take, and no commit
    marker is written."""

    def boom(specs):
        raise RuntimeError("injected pack failure")

    monkeypatch.setattr(dp, "pack_async", boom)
    tree = {f"leaf_{i}": _tensor(_np_array((8, 8), "float32", seed=i)) for i in range(4)}
    p = str(tmp_path / "snap")
    with enable_batching(), enable_device_pack(), override_slab_size_threshold_bytes(1 << 20):
        with pytest.raises(RuntimeError, match="injected pack failure"):
            Snapshot.take(p, {"m": TensorTreeState(tree)})
    assert not os.path.exists(os.path.join(p, SNAPSHOT_METADATA_FNAME))


def test_batched_stager_cost_stable_across_staging() -> None:
    """The staging cost is fixed at construction: staging clears the
    members' tensors, and a later read must see the admission value."""
    from torchsnapshot_tpu_torch import batcher

    copier = DeviceCopier()
    tensors = [_tensor(_np_array((8, 8), "float32", seed=i)) for i in range(2)]
    size = tensors[0].numel() * 4
    items = [
        (WriteReq(path=f"p{i}", buffer_stager=ArrayBufferStager(t, copier)), i * size, size)
        for i, t in enumerate(tensors)
    ]
    with enable_device_pack():
        stager = batcher.BatchedBufferStager(items)
    cost_before = stager.get_staging_cost_bytes()
    buf = asyncio.run(stager.stage_buffer())
    assert len(buf) == 2 * size
    assert bytes(buf) == b"".join(t.numpy().tobytes() for t in tensors)
    assert stager.get_staging_cost_bytes() == cost_before


def test_device_pack_off_by_default(tmp_path, monkeypatch) -> None:
    calls = _spy(monkeypatch)
    tree = {f"leaf_{i}": torch.full((8,), float(i)) for i in range(4)}
    p = str(tmp_path / "snap")
    with enable_batching(), override_slab_size_threshold_bytes(1 << 20):
        Snapshot.take(p, {"m": TensorTreeState(tree)})
    assert calls == []
    assert os.listdir(os.path.join(p, "batched"))
