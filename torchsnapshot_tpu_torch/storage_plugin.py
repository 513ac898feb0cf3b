"""Storage plugin registry: URL scheme -> plugin, plus entry-point extension.

Reference parity: torchsnapshot/storage_plugin.py:17-59. ``fs://`` is the
default scheme for bare paths; ``memory://`` is used by tests and
scratch runs; ``tiered://<fast_url>|<durable_url>`` composes two of them
into a fast commit and a background durable mirror (``tiered/``). The
cloud plugins (``s3://``, ``gs://``) of ``torchsnapshot_tpu`` are not
ported yet. Third-party plugins register via the
``torchsnapshot_tpu_torch.storage_plugins`` entry-point group.
"""

from __future__ import annotations

from importlib.metadata import entry_points
from typing import Optional, Tuple

from .io_types import StoragePlugin

_ENTRY_POINT_GROUP = "torchsnapshot_tpu_torch.storage_plugins"
# Schemes torchsnapshot_tpu serves that this package does not yet.
_NOT_PORTED_SCHEMES = ("s3", "gs")


def normalize_object_key(prefix: str, path: str) -> str:
    """Join an object-store prefix with a blob path, resolving any
    parent-relative components lexically. Incremental snapshots reference
    base-step blobs through ``../step_.../...`` locations; object keys
    have no directory semantics, so ``..`` must be collapsed here (shared
    by the s3 and gcs plugins so ref resolution cannot diverge)."""
    key = f"{prefix}/{path}" if prefix else path
    if ".." in path:
        import posixpath

        key = posixpath.normpath(key)
    return key


def _parse_url(url_path: str) -> Tuple[str, str]:
    if "://" in url_path:
        scheme, _, path = url_path.partition("://")
        return (scheme or "fs", path)
    return ("fs", url_path)


def split_tiered_url(url_path: str) -> Optional[Tuple[str, str]]:
    """``(fast_url, durable_url)`` for a ``tiered://fast|durable`` URL,
    None for any other scheme. Each side is itself a full snapshot URL
    (bare paths mean ``fs://``); nesting tiered inside tiered is
    rejected — the mirror topology is exactly two tiers."""
    scheme, path = _parse_url(url_path)
    if scheme != "tiered":
        return None
    fast, sep, durable = path.partition("|")
    if not sep or not fast or not durable:
        raise ValueError(
            f"tiered URL {url_path!r} must be "
            f"'tiered://<fast_url>|<durable_url>'"
        )
    for side in (fast, durable):
        if _parse_url(side)[0] == "tiered":
            raise ValueError(
                f"tiered URL {url_path!r} nests a tiered tier; only two "
                f"tiers are supported"
            )
    return fast, durable


def join_path(url_path: str, segment: str) -> str:
    """Append a path segment to a snapshot location URL. For tiered URLs
    the segment applies to BOTH tiers (the two trees mirror each other
    blob-for-blob); for every other scheme this is the plain
    ``rstrip('/') + '/' + segment`` join the manager has always used."""
    tiers = split_tiered_url(url_path)
    if tiers is not None:
        fast, durable = tiers
        return f"tiered://{join_path(fast, segment)}|{join_path(durable, segment)}"
    return f"{url_path.rstrip('/')}/{segment}"


def url_to_storage_plugin(url_path: str) -> StoragePlugin:
    """Build the storage plugin for a snapshot location URL.

    A bare path is treated as ``fs://``. Unknown schemes fall through to the
    entry-point registry so external backends can plug in without touching
    this package.
    """
    scheme, path = _parse_url(url_path)

    if scheme == "fs":
        from .storage_plugins.fs import FSStoragePlugin

        return FSStoragePlugin(root=path)
    if scheme == "memory":
        from .storage_plugins.memory import MemoryStoragePlugin

        return MemoryStoragePlugin(name=path or "default")
    if scheme == "tiered":
        from .tiered.plugin import TieredStoragePlugin

        fast_url, durable_url = split_tiered_url(url_path)
        return TieredStoragePlugin(fast_url=fast_url, durable_url=durable_url)
    eps = entry_points(group=_ENTRY_POINT_GROUP)
    for ep in eps:
        if ep.name == scheme:
            return ep.load()(path)
    if scheme in _NOT_PORTED_SCHEMES:
        raise RuntimeError(
            f"Unsupported storage scheme {scheme!r} in {url_path!r}: the "
            f"{scheme}:// plugin of torchsnapshot_tpu is not ported to "
            f"torchsnapshot_tpu_torch yet (ROADMAP queue 1 step 9d)"
        )
    raise RuntimeError(
        f"Unsupported storage scheme {scheme!r} in {url_path!r} "
        f"(built-in: fs, memory, tiered; "
        f"entry-point group: {_ENTRY_POINT_GROUP})"
    )


def url_to_storage_plugin_in_event_loop(
    url_path: str, event_loop: Optional["object"] = None
) -> StoragePlugin:
    """Reference-parity alias (storage_plugin.py:62); plugin construction is
    synchronous here, so the event loop is unused but kept for API shape."""
    return url_to_storage_plugin(url_path)
