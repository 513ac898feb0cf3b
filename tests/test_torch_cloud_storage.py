"""The port's cloud storage plugins, the parts that run offline.

Port of ``tests/test_cloud_storage.py``'s 18 cases: the collective-progress
retry strategy (``storage_plugins/retry.py``, its rng seam and per-instance
totals included), the transient-error taxonomies, root parsing, the
dependency gate, the 404 normalization, the S3 put body, and the full
incremental take -> restore -> fsck chain over ``s3://`` against an
in-memory S3 client (``test_cloud_storage.FakeS3Client``). The cases behind
``importorskip("botocore")`` skip where botocore is absent, as they do for
the JAX package; live buckets are env-gated the same way. Added: an
incremental take over ``s3://`` whose base one package wrote and whose
increment the other did.
"""

import asyncio
import io
import os
import sys
import types

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
from torchsnapshot_tpu_torch.event_loop import run_in_fresh_event_loop
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.storage_plugins.retry import CollectiveProgressRetryStrategy, RetriesExhausted


class Transient(Exception):
    pass


def test_retry_succeeds_after_transient_failures() -> None:
    strategy = CollectiveProgressRetryStrategy(progress_window_seconds=30)
    attempts = 0

    async def op():
        nonlocal attempts
        attempts += 1
        if attempts < 3:
            raise Transient()
        return "ok"

    assert run_in_fresh_event_loop(strategy.run(op, (Transient,))) == "ok"
    assert attempts == 3
    assert strategy.attempts_total == 2 and strategy.exhausted_total == 0


def test_retry_gives_up_when_nobody_progresses() -> None:
    strategy = CollectiveProgressRetryStrategy(progress_window_seconds=0.01)

    async def op():
        raise Transient()

    with pytest.raises(RetriesExhausted):
        run_in_fresh_event_loop(strategy.run(op, (Transient,)))
    assert strategy.exhausted_total == 1


def test_decorrelated_backoff_schedules_diverge() -> None:
    """Two schedules under decorrelated jitter draw each step's range from
    their own previous draw: they diverge after the first sleep and stay
    diverged; a pinned generator gives the same schedule."""
    import random

    from torchsnapshot_tpu_torch.storage_plugins.retry import (
        _BACKOFF_BASE_SECONDS,
        _BACKOFF_MAX_SECONDS,
        decorrelated_backoff,
    )

    def schedule(seed: int, n: int = 8):
        rng = random.Random(seed)
        prev = _BACKOFF_BASE_SECONDS
        out = []
        for _ in range(n):
            prev = decorrelated_backoff(prev, rng=rng)
            out.append(prev)
        return out

    a, b = schedule(1), schedule(2)
    assert a != b
    assert sum(1 for x, y in zip(a, b) if abs(x - y) > 1e-9) >= 6
    for s in a + b:
        assert _BACKOFF_BASE_SECONDS <= s <= _BACKOFF_MAX_SECONDS
    assert schedule(7) == schedule(7)


def test_retry_run_uses_decorrelated_backoff_rng_seam() -> None:
    """Two strategies retrying the same failing op under different
    generators sleep different amounts (their recorded backoff totals)."""
    import random

    totals = []
    for seed in (11, 12):
        strategy = CollectiveProgressRetryStrategy(progress_window_seconds=30, rng=random.Random(seed))
        attempts = 0

        async def op():
            nonlocal attempts
            attempts += 1
            if attempts < 3:
                raise Transient()
            return "ok"

        async def main():
            # The schedules, not the wall clock, are under test.
            orig = asyncio.sleep

            async def fake_sleep(_s):
                await orig(0)

            asyncio.sleep = fake_sleep
            try:
                return await strategy.run(op, (Transient,))
            finally:
                asyncio.sleep = orig

        assert run_in_fresh_event_loop(main()) == "ok"
        totals.append(strategy.backoff_s_total)
    assert totals[0] != totals[1]


def test_retry_nonretriable_raises_immediately() -> None:
    strategy = CollectiveProgressRetryStrategy(progress_window_seconds=30)

    async def op():
        raise ValueError("hard failure")

    with pytest.raises(ValueError):
        run_in_fresh_event_loop(strategy.run(op, (Transient,)))
    assert strategy.attempts_total == 0


def test_concurrent_progress_extends_straggler_deadline() -> None:
    """A straggler keeps retrying while a sibling makes progress."""
    strategy = CollectiveProgressRetryStrategy(progress_window_seconds=0.6)
    straggler_attempts = 0

    async def straggler():
        nonlocal straggler_attempts
        straggler_attempts += 1
        if straggler_attempts < 3:
            raise Transient()
        return "eventually"

    async def sibling():
        # Refresh until cancelled: the straggler's sleeps (~1 s and more)
        # outlast the 0.6 s window, so only these refreshes keep it alive.
        while True:
            await asyncio.sleep(0.1)
            strategy.record_progress()

    async def main():
        sib = asyncio.ensure_future(sibling())
        try:
            return await strategy.run(straggler, (Transient,))
        finally:
            sib.cancel()

    assert run_in_fresh_event_loop(main()) == "eventually"
    assert straggler_attempts == 3


def test_retry_window_starts_at_first_failure_not_construction() -> None:
    """A quiet period longer than the window between construction and the
    first operation does not use up the retry budget."""
    import time as _time

    strategy = CollectiveProgressRetryStrategy(progress_window_seconds=2.0)
    _time.sleep(2.1)
    attempts = 0

    async def op():
        nonlocal attempts
        attempts += 1
        if attempts < 2:
            raise Transient()
        return "ok"

    assert run_in_fresh_event_loop(strategy.run(op, (Transient,))) == "ok"
    assert attempts == 2


def test_s3_transient_taxonomy() -> None:
    pytest.importorskip("botocore")
    import botocore.exceptions as be

    from torchsnapshot_tpu_torch.storage_plugins.s3 import _is_transient_s3

    def client_error(code=None, status=None):
        resp = {"Error": {}, "ResponseMetadata": {}}
        if code is not None:
            resp["Error"]["Code"] = code
        if status is not None:
            resp["ResponseMetadata"]["HTTPStatusCode"] = status
        return be.ClientError(resp, "PutObject")

    assert _is_transient_s3(client_error(code="SlowDown", status=503))
    assert _is_transient_s3(client_error(code="Throttling"))
    assert _is_transient_s3(client_error(status=500))
    assert _is_transient_s3(client_error(status=429))
    assert not _is_transient_s3(client_error(code="AccessDenied", status=403))
    assert not _is_transient_s3(client_error(code="NoSuchKey", status=404))
    assert _is_transient_s3(ConnectionResetError())
    assert not _is_transient_s3(ValueError())


def test_gcs_transient_taxonomy() -> None:
    pytest.importorskip("google.resumable_media")
    import requests
    from google.resumable_media import common

    from torchsnapshot_tpu_torch.storage_plugins.gcs import _is_transient

    class FakeResp:
        def __init__(self, code):
            self.status_code = code

    for code in (408, 429, 500, 503):
        assert _is_transient(common.InvalidResponse(FakeResp(code)), common)
    for code in (400, 403, 404):
        assert not _is_transient(common.InvalidResponse(FakeResp(code)), common)
    assert _is_transient(requests.ConnectionError(), common)
    assert _is_transient(requests.Timeout(), common)
    assert not _is_transient(ValueError(), common)


def test_s3_plugin_gates_missing_dependency() -> None:
    try:
        import aiobotocore  # noqa: F401

        pytest.skip("aiobotocore installed; gating not exercised")
    except ImportError:
        pass
    from torchsnapshot_tpu_torch.storage_plugins.s3 import S3StoragePlugin

    with pytest.raises(RuntimeError, match="aiobotocore"):
        S3StoragePlugin(root="bucket/prefix")


def test_gcs_root_parsing_rejects_empty_bucket() -> None:
    pytest.importorskip("google.resumable_media")
    from torchsnapshot_tpu_torch.storage_plugins.gcs import GCSStoragePlugin

    # The bucket is checked before the credentials are looked up.
    with pytest.raises(ValueError, match="Invalid GCS root"):
        GCSStoragePlugin(root="")


def test_registry_dispatches_schemes(tmp_path) -> None:
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

    assert isinstance(url_to_storage_plugin(str(tmp_path)), FSStoragePlugin)
    assert isinstance(url_to_storage_plugin(f"fs://{tmp_path}"), FSStoragePlugin)
    assert isinstance(url_to_storage_plugin("memory://x"), MemoryStoragePlugin)
    with pytest.raises(RuntimeError, match="Unsupported storage scheme"):
        url_to_storage_plugin("bogus://whatever")


@pytest.mark.skipif("TORCHSNAPSHOT_TPU_ENABLE_GCS_TEST" not in os.environ, reason="live GCS test not enabled")
def test_gcs_live_roundtrip() -> None:
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    plugin = url_to_storage_plugin(os.environ["TORCHSNAPSHOT_TPU_GCS_URL"])

    async def go():
        data = os.urandom(1 << 20)
        await plugin.write(WriteIO(path="smoke/blob", buf=data))
        io_ = ReadIO(path="smoke/blob", byte_range=(100, 1100))
        await plugin.read(io_)
        assert bytes(io_.buf) == data[100:1100]
        await plugin.delete("smoke/blob")
        await plugin.close()

    run_in_fresh_event_loop(go())


def _bare_s3_plugin(client):
    """An ``S3StoragePlugin`` on a fake client, built without aiobotocore."""
    from torchsnapshot_tpu_torch.storage_plugins.s3 import S3StoragePlugin

    plugin = S3StoragePlugin.__new__(S3StoragePlugin)
    plugin.bucket = "b"
    plugin.prefix = "p"
    plugin._retry = CollectiveProgressRetryStrategy(progress_window_seconds=1.0)

    async def fake_get_client():
        return client

    plugin._get_client = fake_get_client
    return plugin


def test_s3_missing_key_normalized_to_file_not_found() -> None:
    """A missing key raises FileNotFoundError (the fs plugin's contract)
    and is never retried."""
    pytest.importorskip("botocore")
    import botocore.exceptions as be

    from torchsnapshot_tpu_torch.storage_plugins.s3 import _is_transient_s3

    assert not _is_transient_s3(FileNotFoundError("x"))

    class FakeClient:
        async def get_object(self, Bucket, Key, **kw):
            raise be.ClientError({"Error": {"Code": "NoSuchKey"}, "ResponseMetadata": {}}, "GetObject")

    plugin = _bare_s3_plugin(FakeClient())

    async def go():
        with pytest.raises(FileNotFoundError):
            await plugin.read(ReadIO(path="missing"))

    run_in_fresh_event_loop(go())


def test_gcs_missing_blob_normalized_to_file_not_found() -> None:
    pytest.importorskip("google.resumable_media")
    from google.resumable_media import common

    from torchsnapshot_tpu_torch.storage_plugins.gcs import GCSStoragePlugin, _is_transient

    assert not _is_transient(FileNotFoundError("x"), common)

    class FakeResp:
        status_code = 404

    class FakeDownload:
        def __init__(self, *a, **kw):
            self.finished = False

        def consume_next_chunk(self, session):
            raise common.InvalidResponse(FakeResp(), "not found")

    plugin = GCSStoragePlugin.__new__(GCSStoragePlugin)
    plugin._common = common
    plugin._chunked_download_cls = FakeDownload
    plugin._session = None
    plugin._base_url = "https://storage.example"
    plugin.bucket = "b"
    plugin.prefix = "p"
    with pytest.raises(FileNotFoundError):
        plugin._download_sync("missing", None)


def test_s3_put_body_streams_without_copy() -> None:
    """put_object gets a seekable file-like body over the staged buffer
    itself (its reads are views of the buffer's memory, not copies), and
    draining it gives the buffer's bytes. Needs no botocore: the fake
    client is the consumer."""
    payload = torch.arange(100000, dtype=torch.float32).numpy()
    staged = payload.view(np.uint8)
    captured = {}

    class FakeClient:
        async def put_object(self, Bucket, Key, Body):
            assert Body.seekable() and Body.readable()
            Body.seek(0, io.SEEK_END)
            length = Body.tell()
            Body.seek(0)
            chunks = []
            while True:
                c = Body.read(64 * 1024)
                if not len(c):
                    break
                chunks.append(c)
            captured["aliases"] = all(np.shares_memory(np.frombuffer(c, np.uint8), staged) for c in chunks)
            captured["key"] = Key
            captured["data"] = b"".join(bytes(c) for c in chunks)
            assert len(captured["data"]) == length

    plugin = _bare_s3_plugin(FakeClient())
    run_in_fresh_event_loop(plugin.write(WriteIO(path="blob", buf=memoryview(staged))))
    assert captured["key"] == "p/blob"
    assert captured["data"] == payload.tobytes()
    assert captured["aliases"]


def _stub_botocore(monkeypatch) -> None:
    """Without botocore, ``botocore.exceptions`` as a stub with the classes
    the plugins touch, for this test only (so that no later test finds it
    and runs against it)."""
    try:
        import botocore.exceptions  # noqa: F401

        return
    except ImportError:
        pass
    exceptions = types.ModuleType("botocore.exceptions")

    class ClientError(Exception):
        def __init__(self, response, operation_name):
            super().__init__(response.get("Error", {}).get("Code", "?"))
            self.response = response
            self.operation_name = operation_name

    for name in ("EndpointConnectionError", "ConnectionError", "HTTPClientError", "ReadTimeoutError",
                 "ConnectTimeoutError"):
        setattr(exceptions, name, type(name, (Exception,), {}))
    exceptions.ClientError = ClientError
    botocore = types.ModuleType("botocore")
    botocore.exceptions = exceptions
    monkeypatch.setitem(sys.modules, "botocore", botocore)
    monkeypatch.setitem(sys.modules, "botocore.exceptions", exceptions)


@pytest.fixture()
def fake_s3(monkeypatch):
    """``s3://`` through both packages' real S3 plugins, backed by one
    shared in-memory client (every plugin a take, restore or fsck builds,
    in either package, sees the same objects)."""
    from test_cloud_storage import FakeS3Client
    from torchsnapshot_tpu.storage_plugins import retry as jax_retry
    from torchsnapshot_tpu.storage_plugins.s3 import S3StoragePlugin as JaxS3StoragePlugin

    from torchsnapshot_tpu_torch.storage_plugins.s3 import S3StoragePlugin

    _stub_botocore(monkeypatch)
    store: dict = {}

    async def fake_get_client(self):
        return FakeS3Client(store)

    for cls, strategy in (
        (S3StoragePlugin, CollectiveProgressRetryStrategy),
        (JaxS3StoragePlugin, jax_retry.CollectiveProgressRetryStrategy),
    ):

        def fake_init(self, root: str, strategy=strategy) -> None:
            bucket, _, prefix = root.partition("/")
            if not bucket:
                raise ValueError(f"Invalid S3 root {root!r}")
            self.bucket = bucket
            self.prefix = prefix.strip("/")
            self._client_ctx = None
            self._client = None
            self._client_lock = asyncio.Lock()
            self._retry = strategy()

        monkeypatch.setattr(cls, "__init__", fake_init)
        monkeypatch.setattr(cls, "_get_client", fake_get_client)
    return store


def test_incremental_refs_resolve_over_s3(fake_s3) -> None:
    """Incremental ``../step_X`` refs over s3:// end to end: take,
    incremental take, restore, deep fsck, read_object, with checksum
    inheritance; object keys are flat, so ``..`` collapses lexically and
    never reaches the store."""
    from torchsnapshot_tpu_torch.fsck import verify_snapshot

    w = torch.arange(128, dtype=torch.float32)
    b = torch.ones(16)
    base, incr = "s3://bkt/run/step_0", "s3://bkt/run/step_1"
    Snapshot.take(base, {"m": TensorTreeState({"w": w, "b": b})}, record_digests=True)
    Snapshot.take(incr, {"m": TensorTreeState({"w": w.clone(), "b": b * 2})}, incremental_base=base)

    assert Snapshot(incr).get_manifest()["0/m/w"].location == "../step_0/0/m/w"
    assert all(".." not in k for _, k in fake_s3)
    assert any(k.startswith("run/step_0/") for _, k in fake_s3)

    dest = TensorTreeState({"w": torch.zeros_like(w), "b": torch.zeros_like(b)})
    Snapshot(incr).restore({"m": dest})
    assert torch.equal(dest.tree["w"], w) and torch.equal(dest.tree["b"], b * 2)

    report = verify_snapshot(incr, deep=True)
    assert report.ok and report.crcs_verified == report.blobs_checked
    assert torch.equal(Snapshot(incr).read_object("0/m/w"), w)


@pytest.mark.parametrize("base_writer", ["jax", "port"])
def test_incremental_over_s3_across_packages(fake_s3, base_writer) -> None:
    """The base by one package (digests recorded), the increment by the
    other: the unchanged leaf is a ref into the base, and both packages
    restore the increment bit for bit and deep-fsck it clean."""
    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.fsck import verify_snapshot as jax_verify

    from torchsnapshot_tpu_torch.fsck import verify_snapshot

    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    base, incr = f"s3://bkt/x{base_writer}/step_0", f"s3://bkt/x{base_writer}/step_1"
    port_tree = lambda w, b: TensorTreeState({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})  # noqa: E731
    jax_tree = lambda w, b: jts.PyTreeState({"w": w, "b": b})  # noqa: E731
    if base_writer == "jax":
        jts.Snapshot.take(base, {"m": jax_tree(w, b)}, record_digests=True)
        Snapshot.take(incr, {"m": port_tree(w.copy(), b * 2)}, incremental_base=base)
        location = Snapshot(incr).get_manifest()["0/m/w"].location
    else:
        Snapshot.take(base, {"m": port_tree(w, b)}, record_digests=True)
        jts.Snapshot.take(incr, {"m": jax_tree(w.copy(), b * 2)}, incremental_base=base)
        location = jts.Snapshot(incr).get_manifest()["0/m/w"].location
    assert location == "../step_0/0/m/w"

    port_dest = TensorTreeState({"w": torch.zeros(w.shape), "b": torch.zeros(b.shape)})
    Snapshot(incr).restore({"m": port_dest})
    jax_dest = jts.PyTreeState({"w": np.zeros_like(w), "b": np.zeros_like(b)})
    jts.Snapshot(incr).restore({"m": jax_dest})
    for got in (port_dest.tree["w"].numpy(), np.asarray(jax_dest.tree["w"])):
        assert got.tobytes() == w.tobytes()
    for got in (port_dest.tree["b"].numpy(), np.asarray(jax_dest.tree["b"])):
        assert got.tobytes() == (b * 2).tobytes()
    for report in (verify_snapshot(incr, deep=True), jax_verify(incr, deep=True)):
        assert report.ok and report.crcs_verified == report.blobs_checked


@pytest.mark.s3_integration_test
@pytest.mark.skipif(
    "TORCHSNAPSHOT_TPU_ENABLE_AWS_TEST" not in os.environ or "TORCHSNAPSHOT_TPU_S3_URL" not in os.environ,
    reason="live/emulated S3 test not enabled (set both TORCHSNAPSHOT_TPU_ENABLE_AWS_TEST and "
    "TORCHSNAPSHOT_TPU_S3_URL; a default bucket name would be squattable on real AWS)",
)
def test_s3_live_roundtrip() -> None:
    """Write, ranged read and delete against real S3 or an S3-compatible
    endpoint (``TORCHSNAPSHOT_TPU_S3_ENDPOINT``)."""
    pytest.importorskip("botocore")
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    plugin = url_to_storage_plugin(os.environ["TORCHSNAPSHOT_TPU_S3_URL"])

    async def go():
        data = os.urandom(1 << 20)
        await plugin.write(WriteIO(path="smoke/blob", buf=data))
        io_ = ReadIO(path="smoke/blob", byte_range=(100, 1100))
        await plugin.read(io_)
        assert bytes(io_.buf) == data[100:1100]
        await plugin.delete("smoke/blob")
        await plugin.close()

    run_in_fresh_event_loop(go())
