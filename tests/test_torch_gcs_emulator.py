"""The port's gcs plugin against a real local HTTP server (``tests/fake_gcs.py``).

Port of ``tests/test_gcs_emulator.py``'s seven cases on the same server:
resumable-upload chunking and RECOVER, ranged chunked downloads, the 404
normalization, the transient-retry taxonomy, and whole takes over
``gs://`` (full and incremental, with a deep fsck). Added: the port's take
over ``gs://`` restored by the JAX package, and the reverse.
"""

import asyncio
import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch.storage_plugins.gcs as gcs_mod
from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
from torchsnapshot_tpu_torch.fsck import verify_snapshot
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO

from fake_gcs import FakeGCSServer


@pytest.fixture()
def emulator(monkeypatch):
    srv = FakeGCSServer()
    monkeypatch.setenv("STORAGE_EMULATOR_HOST", srv.start())
    yield srv
    srv.stop()


def _run(coro):
    return asyncio.run(coro)


def test_write_read_delete_roundtrip(emulator) -> None:
    async def main():
        p = gcs_mod.GCSStoragePlugin("bkt/prefix")
        data = bytes(range(256)) * 64
        await p.write(WriteIO(path="x/y", buf=data))
        rio = ReadIO(path="x/y")
        await p.read(rio)
        assert bytes(rio.buf) == data
        rio = ReadIO(path="x/y", byte_range=(10, 5000))
        await p.read(rio)
        assert bytes(rio.buf) == data[10:5000]
        with pytest.raises(FileNotFoundError):
            await p.read(ReadIO(path="nope"))
        await p.delete("x/y")
        with pytest.raises(FileNotFoundError):
            await p.read(ReadIO(path="x/y"))
        await p.close()

    _run(main())
    assert "prefix/x/y" not in emulator.blobs


def test_resumable_upload_recovers_mid_upload(emulator, monkeypatch) -> None:
    """A 503 on a middle chunk makes the upload probe the confirmed offset
    (a 'bytes */N' request answered 308 + Range) and resume there: the
    write neither fails nor restarts from byte 0."""
    monkeypatch.setattr(gcs_mod, "_UPLOAD_CHUNK_SIZE", 256 * 1024)
    data = os.urandom(1280 * 1024)  # 5 chunks of 256 KiB

    async def main():
        p = gcs_mod.GCSStoragePlugin("bkt")
        emulator.fail_next(1, status=503, where="chunk")
        await p.write(WriteIO(path="big", buf=memoryview(data)))
        rio = ReadIO(path="big")
        await p.read(rio)
        assert bytes(rio.buf) == data
        await p.close()

    _run(main())
    assert emulator.request_counts["chunk"] >= 6  # 5 chunks and the failed one
    assert emulator.request_counts["probe"] >= 1


def test_initiate_5xx_retried_by_collective_strategy(emulator) -> None:
    emulator.fail_next(2, status=503, where="initiate")

    async def main():
        p = gcs_mod.GCSStoragePlugin("bkt")
        await p.write(WriteIO(path="k", buf=b"payload"))
        rio = ReadIO(path="k")
        await p.read(rio)
        assert bytes(rio.buf) == b"payload"
        await p.close()

    _run(main())
    assert emulator.request_counts["initiate"] == 3


def test_download_5xx_retried(emulator) -> None:
    async def main():
        p = gcs_mod.GCSStoragePlugin("bkt")
        await p.write(WriteIO(path="k", buf=b"v" * 1000))
        emulator.fail_next(1, status=500, where="download")
        rio = ReadIO(path="k")
        await p.read(rio)
        assert bytes(rio.buf) == b"v" * 1000
        await p.close()

    _run(main())


def test_nonretriable_4xx_raises(emulator) -> None:
    async def main():
        p = gcs_mod.GCSStoragePlugin("bkt")
        emulator.fail_next(1, status=403, where="initiate")
        with pytest.raises(Exception) as ei:
            await p.write(WriteIO(path="k", buf=b"x"))
        assert "403" in str(ei.value) or "InvalidResponse" in type(ei.value).__name__
        await p.close()

    _run(main())
    assert emulator.request_counts["initiate"] == 1  # no retry on 403


def test_snapshot_roundtrip_over_gs_scheme(emulator) -> None:
    """The whole checkpointer over gs://: take, commit marker, restore bit
    for bit, all through the HTTP server."""
    tree = {"w": torch.arange(4096, dtype=torch.float32).reshape(64, 64), "step": 3}
    Snapshot.take("gs://bkt/ckpt", {"s": TensorTreeState(tree)})
    assert any(b.endswith(".snapshot_metadata") for b in emulator.blobs)
    dst = TensorTreeState({"w": torch.zeros((64, 64)), "step": 0})
    Snapshot("gs://bkt/ckpt").restore({"s": dst})
    assert torch.equal(dst.tree["w"], tree["w"])
    assert dst.tree["step"] == 3


def test_incremental_refs_resolve_over_gcs(emulator) -> None:
    """Incremental ``../step_X`` refs resolve in the server's flat object
    namespace, checksums inherited, the chain deep-fscked."""
    w = torch.arange(128, dtype=torch.float32)
    b = torch.ones(16)
    base, incr = "gs://bkt/run/step_0", "gs://bkt/run/step_1"
    Snapshot.take(base, {"m": TensorTreeState({"w": w, "b": b})}, record_digests=True)
    Snapshot.take(incr, {"m": TensorTreeState({"w": w.clone(), "b": b * 2})}, incremental_base=base)
    assert Snapshot(incr).get_manifest()["0/m/w"].location == "../step_0/0/m/w"
    assert all(".." not in blob for blob in emulator.blobs)

    dest = TensorTreeState({"w": torch.zeros_like(w), "b": torch.zeros_like(b)})
    Snapshot(incr).restore({"m": dest})
    assert torch.equal(dest.tree["w"], w) and torch.equal(dest.tree["b"], b * 2)

    report = verify_snapshot(incr, deep=True)
    assert report.ok and report.crcs_verified == report.blobs_checked
    assert torch.equal(Snapshot(incr).read_object("0/m/w"), w)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gs_take_restores_across_packages(emulator, writer) -> None:
    """A take over gs:// by either package restores in the other, bit for
    bit, through the same server."""
    import torchsnapshot_tpu as jts

    w = np.random.default_rng(0).standard_normal((32, 48)).astype(np.float32)
    url = f"gs://bkt/cross/{writer}"
    if writer == "port":
        Snapshot.take(url, {"s": TensorTreeState({"w": torch.from_numpy(w), "step": 7})})
        dst = jts.PyTreeState({"w": np.zeros_like(w), "step": 0})
        jts.Snapshot(url).restore({"s": dst})
        got = np.asarray(dst.tree["w"])
    else:
        jts.Snapshot.take(url, {"s": jts.PyTreeState({"w": w, "step": 7})})
        dst = TensorTreeState({"w": torch.zeros(w.shape), "step": 0})
        Snapshot(url).restore({"s": dst})
        got = dst.tree["w"].numpy()
    assert got.tobytes() == w.tobytes()
    assert dst.tree["step"] == 7
