"""S3 storage plugin (``s3://bucket/prefix``).

Counterpart of ``torchsnapshot_tpu/storage_plugins/s3.py``: aiobotocore
``put_object`` with a body that streams the staged buffer, ranged reads
(S3's ``Range`` header takes an inclusive end), one client per plugin. A
missing key raises ``FileNotFoundError`` and a range outside the blob
``OSError(EIO)``, as the fs plugin does; throttles, 5xx answers and
connection failures retry under the collective-progress strategy
(``retry.py``). aiobotocore is imported when a plugin is built, not with
the package: without it, building one raises with the package to install.
``TORCHSNAPSHOT_TPU_S3_ENDPOINT`` points the client at an S3-compatible
endpoint other than AWS.
"""

from __future__ import annotations

import asyncio
import errno
import time

from .. import knobs
from ..io_types import ReadIO, StoragePlugin, WriteIO, as_bytes_view
from ..telemetry import observe_io
from ..telemetry.trace import io_span
from .retry import CollectiveProgressRetryStrategy

_TRANSIENT_S3_CODES = frozenset(
    {"SlowDown", "Throttling", "ThrottlingException", "RequestTimeout",
     "RequestLimitExceeded", "InternalError", "ServiceUnavailable"}
)


def _import_aiobotocore():
    try:
        from aiobotocore.session import get_session
    except ImportError as e:
        raise RuntimeError("S3 support requires aiobotocore (pip install aiobotocore)") from e
    return get_session


def _is_transient_s3(exc: BaseException) -> bool:
    """Throttles (503 SlowDown, 429), 408, 5xx and connection-level
    failures retry; auth and other 4xx answers, a missing key and a range
    outside the blob do not."""
    import botocore.exceptions as be

    if isinstance(exc, be.ClientError):
        err = exc.response.get("Error", {})
        status = exc.response.get("ResponseMetadata", {}).get("HTTPStatusCode")
        if err.get("Code") in _TRANSIENT_S3_CODES:
            return True
        return status is not None and (status in (408, 429) or status >= 500)
    if isinstance(exc, (be.EndpointConnectionError, be.ConnectionError, be.HTTPClientError,
                        be.ReadTimeoutError, be.ConnectTimeoutError)):
        return True
    if isinstance(exc, FileNotFoundError):
        return False
    if isinstance(exc, OSError) and exc.errno == errno.EIO:
        return False
    return isinstance(exc, (OSError, asyncio.TimeoutError))


class _TransientS3Error(Exception):
    pass


class S3StoragePlugin(StoragePlugin):
    def __init__(self, root: str) -> None:
        get_session = _import_aiobotocore()
        bucket, _, prefix = root.partition("/")
        if not bucket:
            raise ValueError(f"Invalid S3 root {root!r}; expected 'bucket[/prefix]'")
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self._session = get_session()
        self._client_ctx = None
        self._client = None
        self._client_lock = asyncio.Lock()
        self._retry = CollectiveProgressRetryStrategy(scope="s3")

    def _key(self, path: str) -> str:
        from ..storage_plugin import normalize_object_key

        return normalize_object_key(self.prefix, path)

    async def _get_client(self):
        # One client for the plugin: concurrent first operations must not
        # each enter a client context (all but one would leak a connector).
        if self._client is None:
            async with self._client_lock:
                if self._client is None:
                    endpoint = knobs.get_s3_endpoint_url()
                    kwargs = {"endpoint_url": endpoint} if endpoint else {}
                    self._client_ctx = self._session.create_client("s3", **kwargs)
                    self._client = await self._client_ctx.__aenter__()
        return self._client

    async def _run_retrying(self, op):
        async def guarded():
            try:
                return await op()
            except Exception as e:
                if _is_transient_s3(e):
                    raise _TransientS3Error() from e
                raise

        return await self._retry.run(guarded, retriable_exceptions=(_TransientS3Error,))

    async def write(self, write_io: WriteIO) -> None:
        from ..memoryview_stream import MemoryviewStream

        client = await self._get_client()
        view = as_bytes_view(write_io.buf)

        async def op() -> None:
            # A seekable file-like body: botocore reads the length, streams
            # the staged buffer and rewinds it on a retry; no bytes copy.
            await client.put_object(Bucket=self.bucket, Key=self._key(write_io.path), Body=MemoryviewStream(view))

        t0 = time.monotonic()
        with io_span("s3", "write", write_io.path, view.nbytes):
            await self._run_retrying(op)
        observe_io("s3", "write", view.nbytes, time.monotonic() - t0)

    async def read(self, read_io: ReadIO) -> None:
        client = await self._get_client()
        kwargs = {}
        if read_io.byte_range is not None:
            start, end = read_io.byte_range
            kwargs["Range"] = f"bytes={start}-{end - 1}"

        async def op() -> bytes:
            import botocore.exceptions as be

            try:
                resp = await client.get_object(Bucket=self.bucket, Key=self._key(read_io.path), **kwargs)
            except be.ClientError as e:
                code = e.response.get("Error", {}).get("Code")
                status = e.response.get("ResponseMetadata", {}).get("HTTPStatusCode")
                if code in ("NoSuchKey", "404"):
                    raise FileNotFoundError(read_io.path) from e
                if code == "InvalidRange" or status == 416:
                    raise OSError(
                        errno.EIO, f"ranged read {read_io.byte_range} is outside the blob", read_io.path
                    ) from e
                raise
            async with resp["Body"] as stream:
                return await stream.read()

        t0 = time.monotonic()
        with io_span("s3", "read", read_io.path, byte_range=read_io.byte_range):
            read_io.buf = memoryview(await self._run_retrying(op))
        observe_io("s3", "read", read_io.buf.nbytes, time.monotonic() - t0)

    async def delete(self, path: str) -> None:
        client = await self._get_client()

        async def op() -> None:
            await client.delete_object(Bucket=self.bucket, Key=self._key(path))

        await self._run_retrying(op)

    async def close(self) -> None:
        if self._client_ctx is not None:
            await self._client_ctx.__aexit__(None, None, None)
            self._client = None
            self._client_ctx = None
