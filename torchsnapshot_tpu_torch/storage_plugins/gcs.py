"""Google Cloud Storage plugin (``gs://bucket/prefix``).

Counterpart of ``torchsnapshot_tpu/storage_plugins/gcs.py``: resumable
uploads in chunks that RECOVER from a failed chunk at the offset the
server confirmed, ranged chunked downloads, the transient-error taxonomy
(408, 429, 5xx, connection failures) under the collective-progress
retry (``retry.py``). The blocking ``google-resumable-media`` calls run
on a thread pool sized by ``knobs.get_per_rank_io_concurrency()``. A
missing blob raises ``FileNotFoundError`` and a range outside the blob
``OSError(EIO)``, as the fs plugin does.

Auth: application-default credentials. ``STORAGE_EMULATOR_HOST`` (the
fake-gcs-server convention, ``host:port`` or a URL) sends every request
to that emulator through a plain ``requests`` session, without auth.
google-auth, google-resumable-media and requests are imported when a
plugin is built, not with the package.
"""

from __future__ import annotations

import asyncio
import errno
import io
import os
import random
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Tuple

from .. import knobs, telemetry
from ..io_types import ReadIO, StoragePlugin, WriteIO, as_bytes_view
from ..telemetry import names as metric_names
from ..telemetry import observe_io
from ..telemetry.trace import get_recorder as _trace_recorder
from ..utils.tracing import trace_annotation
from .retry import CollectiveProgressRetryStrategy

_UPLOAD_CHUNK_SIZE = 100 * 1024 * 1024
_DOWNLOAD_CHUNK_SIZE = 100 * 1024 * 1024
# RECOVER inside the upload thread keeps the resumable session through a
# brief brownout (losing it restarts the upload from byte 0). Its sleeps
# block an I/O thread, so they are short and few (~8 s in all) before the
# failure goes to the async retry strategy, whose sleeps hold no thread.
_MAX_RECOVER_ATTEMPTS = 6
_RECOVER_SLEEP_CAP_SECONDS = 2.0


def _import_gcs_deps():
    try:
        import google.auth  # noqa: F401
        from google.auth.transport.requests import AuthorizedSession
        from google.resumable_media import common
        from google.resumable_media.requests import ChunkedDownload, ResumableUpload
    except ImportError as e:
        raise RuntimeError(
            "GCS support requires google-auth and google-resumable-media "
            "(pip install google-auth google-resumable-media[requests])"
        ) from e
    return google.auth, AuthorizedSession, common, ChunkedDownload, ResumableUpload


def _is_transient(exc: BaseException, common: Any) -> bool:
    """HTTP 408, 429 and 5xx answers, connection failures, timeouts and
    corrupt transfers retry; everything else does not."""
    import requests

    if isinstance(exc, common.InvalidResponse):
        return exc.response.status_code in (408, 429) or 500 <= exc.response.status_code < 600
    if isinstance(exc, (requests.ConnectionError, requests.Timeout)):
        return True
    return isinstance(exc, common.DataCorruption)


class _TransientGCSError(Exception):
    pass


class GCSStoragePlugin(StoragePlugin):
    def __init__(self, root: str) -> None:
        (
            self._google_auth,
            authorized_session_cls,
            self._common,
            self._chunked_download_cls,
            self._resumable_upload_cls,
        ) = _import_gcs_deps()
        bucket, _, prefix = root.partition("/")
        if not bucket:
            raise ValueError(f"Invalid GCS root {root!r}; expected 'bucket[/prefix]'")
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        emulator = os.environ.get("STORAGE_EMULATOR_HOST")
        if emulator:
            if "://" not in emulator:
                emulator = f"http://{emulator}"
            self._base_url = emulator.rstrip("/")
            import requests

            self._session = requests.Session()
        else:
            self._base_url = "https://storage.googleapis.com"
            credentials, _ = self._google_auth.default(
                scopes=["https://www.googleapis.com/auth/devstorage.read_write"]
            )
            self._session = authorized_session_cls(credentials)
        self._executor = ThreadPoolExecutor(
            max_workers=knobs.get_per_rank_io_concurrency(), thread_name_prefix="gcs-io"
        )
        self._retry = CollectiveProgressRetryStrategy(scope="gcs")

    def _blob_name(self, path: str) -> str:
        from ..storage_plugin import normalize_object_key

        return normalize_object_key(self.prefix, path)

    def _upload_sync(self, path: str, data: bytes) -> None:
        with trace_annotation(metric_names.SPAN_STORAGE_WRITE, plugin="gcs", blob=path, bytes=len(data)):
            self._upload_sync_impl(path, data)

    def _upload_sync_impl(self, path: str, data: bytes) -> None:
        blob = self._blob_name(path)
        url = f"{self._base_url}/upload/storage/v1/b/{self.bucket}/o?uploadType=resumable"
        upload = self._resumable_upload_cls(url, _UPLOAD_CHUNK_SIZE)
        # The library's own retries (blocking sleeps of up to minutes in an
        # I/O thread, unseen by the collective deadline) are off: the
        # RECOVER loop below and the async strategy are the retries.
        upload._retry_strategy = self._common.RetryStrategy(max_retries=0)
        upload.initiate(
            self._session, io.BytesIO(data), {"name": blob}, "application/octet-stream", total_bytes=len(data)
        )
        recover_attempts = 0
        while not upload.finished:
            try:
                upload.transmit_next_chunk(self._session)
                recover_attempts = 0
            except Exception as e:
                # Ask the server how far it got, rewind the stream there and
                # go on; bounded, so that a long brownout reaches the
                # collective retry instead of spinning here.
                if not _is_transient(e, self._common) or recover_attempts >= _MAX_RECOVER_ATTEMPTS:
                    raise
                time.sleep(min(_RECOVER_SLEEP_CAP_SECONDS, 0.25 * 2**recover_attempts) * (0.5 + random.random()))
                upload.recover(self._session)
                recover_attempts += 1
                telemetry.metrics().counter_inc(metric_names.GCS_RECOVER_ATTEMPTS_TOTAL)
                _trace_recorder().instant(metric_names.INSTANT_GCS_RECOVER, blob=blob, attempt=recover_attempts)

    def _download_sync(self, path: str, byte_range: Optional[Tuple[int, int]]) -> bytes:
        args = {"plugin": "gcs", "blob": path}
        if byte_range is not None:
            args["range"] = [int(byte_range[0]), int(byte_range[1])]
        with trace_annotation(metric_names.SPAN_STORAGE_READ, **args):
            return self._download_sync_impl(path, byte_range)

    def _download_sync_impl(self, path: str, byte_range: Optional[Tuple[int, int]]) -> bytes:
        blob = urllib.parse.quote(self._blob_name(path), safe="")
        url = f"{self._base_url}/download/storage/v1/b/{self.bucket}/o/{blob}?alt=media"
        stream = io.BytesIO()
        if byte_range is not None:
            start, end = byte_range
            # The API's end is inclusive.
            download = self._chunked_download_cls(url, _DOWNLOAD_CHUNK_SIZE, stream, start=start, end=end - 1)
        else:
            download = self._chunked_download_cls(url, _DOWNLOAD_CHUNK_SIZE, stream)
        download._retry_strategy = self._common.RetryStrategy(max_retries=0)
        try:
            while not download.finished:
                download.consume_next_chunk(self._session)
        except self._common.InvalidResponse as e:
            status = getattr(e.response, "status_code", None)
            if status == 404:
                raise FileNotFoundError(path) from e
            if status == 416:
                raise OSError(errno.EIO, f"ranged read {byte_range} is outside the blob", path) from e
            raise
        return stream.getvalue()

    def _delete_sync(self, path: str) -> None:
        blob = urllib.parse.quote(self._blob_name(path), safe="")
        resp = self._session.delete(f"{self._base_url}/storage/v1/b/{self.bucket}/o/{blob}")
        if resp.status_code not in (200, 204, 404):
            raise self._common.InvalidResponse(resp, "delete failed")

    async def write(self, write_io: WriteIO) -> None:
        loop = asyncio.get_running_loop()
        # The upload's chunks are request bodies of bytes.
        data = bytes(as_bytes_view(write_io.buf))

        async def op() -> None:
            await loop.run_in_executor(self._executor, self._upload_sync, write_io.path, data)

        t0 = time.monotonic()
        await self._run_retrying(op)
        observe_io("gcs", "write", len(data), time.monotonic() - t0)

    async def read(self, read_io: ReadIO) -> None:
        loop = asyncio.get_running_loop()

        async def op() -> bytes:
            return await loop.run_in_executor(self._executor, self._download_sync, read_io.path, read_io.byte_range)

        t0 = time.monotonic()
        read_io.buf = memoryview(await self._run_retrying(op))
        observe_io("gcs", "read", read_io.buf.nbytes, time.monotonic() - t0)

    async def delete(self, path: str) -> None:
        loop = asyncio.get_running_loop()

        async def op() -> None:
            await loop.run_in_executor(self._executor, self._delete_sync, path)

        await self._run_retrying(op)

    async def _run_retrying(self, op):
        async def guarded():
            try:
                return await op()
            except Exception as e:
                if _is_transient(e, self._common):
                    raise _TransientGCSError() from e
                raise

        return await self._retry.run(guarded, retriable_exceptions=(_TransientGCSError,))

    async def close(self) -> None:
        self._executor.shutdown(wait=False)
