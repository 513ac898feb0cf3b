"""Reversible flattening of nested containers into ``{path: leaf}`` maps.

Reference parity: torchsnapshot/flatten.py:18-215. Same behavioral contract:

- ``/`` separates hierarchy levels; ``%``/``/`` inside user keys are
  percent-encoded (``%25``/``%2F``) so paths are unambiguous.
- Exactly ``list``, ``dict`` and ``OrderedDict`` instances flatten; a dict
  whose keys are not all str/int, or whose stringified keys collide, stays an
  opaque leaf (it will be pickled whole).
- ``inflate`` reconstructs the original nesting from the container manifest
  plus the flattened leaves, recovering int dict keys.

The implementation is iterative (explicit work stack for flatten, deepest-
first assembly for inflate) rather than recursive.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Tuple
from urllib.parse import unquote

from .manifest import DictEntry, Entry, ListEntry, Manifest, OrderedDictEntry


def _encode(s: str) -> str:
    """Escape ``%`` then ``/`` (subset of RFC 3986 sufficient for
    reversibility; decode is a full ``unquote``)."""
    return s.replace("%", "%25").replace("/", "%2F")


def _decode(s: str) -> str:
    return unquote(s)


def _is_flattenable_dict(d: Dict[Any, Any]) -> bool:
    keys = list(d.keys())
    # bool is an int subclass but str(True) can't be recovered as a key by
    # inflate; bool-keyed dicts stay opaque leaves.
    if not all(
        isinstance(k, (str, int)) and not isinstance(k, bool) for k in keys
    ):
        return False
    return len({str(k) for k in keys}) == len(keys)


def flatten(obj: Any, prefix: str) -> Tuple[Manifest, Dict[str, Any]]:
    """Flatten ``obj`` under an encoded ``prefix``.

    Returns ``(container_manifest, {path: leaf})``. See module docstring for
    the contract; matches the reference doctest at flatten.py:29-44.
    """
    manifest: Manifest = {}
    flattened: Dict[str, Any] = {}
    stack: List[Tuple[str, Any]] = [(_encode(prefix), obj)]
    while stack:
        path, node = stack.pop()
        node_type = type(node)
        if node_type is list:
            manifest[path] = ListEntry()
            # Reversed push keeps result insertion order stable (cosmetic).
            for idx in reversed(range(len(node))):
                stack.append((f"{path}/{idx}", node[idx]))
        elif node_type in (dict, OrderedDict) and _is_flattenable_dict(node):
            keys = list(node.keys())
            if node_type is dict:
                manifest[path] = DictEntry(keys=keys)
            else:
                manifest[path] = OrderedDictEntry(keys=keys)
            for key in reversed(keys):
                stack.append((f"{path}/{_encode(str(key))}", node[key]))
        else:
            flattened[path] = node
    return manifest, flattened


def inflate(
    manifest: Manifest, flattened: Dict[str, Any], prefix: str
) -> Any:
    """Rebuild the nested object flattened under ``prefix``.

    Containers are instantiated from their entries, then populated deepest-
    first so children exist before their parents consume them.
    """
    prefix = _encode(prefix)
    manifest = {k: v for k, v in manifest.items() if k.split("/", 1)[0] == prefix}
    flattened = {k: v for k, v in flattened.items() if k.split("/", 1)[0] == prefix}

    if prefix in flattened:
        # flatten() of a non-flattenable object yields ({}, {prefix: obj}).
        return flattened[prefix]
    if prefix not in manifest:
        raise AssertionError(
            f"{prefix} is absent from both the container manifest and the "
            f"flattened leaves.\nmanifest: {manifest}\nflattened: {flattened}"
        )

    containers: Dict[str, Any] = {
        path: _new_container(entry) for path, entry in manifest.items()
    }

    # Attach every value (leaf or container) to its parent container,
    # processing deepest paths first so containers are complete when their
    # parents pick them up. (list order / dict key fidelity is handled by
    # _attach.)
    items = list(containers.items()) + list(flattened.items())
    pending: Dict[str, Dict[str, Any]] = {}
    for path, value in items:
        if path == prefix:
            continue
        parent, _, key = path.rpartition("/")
        pending.setdefault(parent, {})[key] = value

    for parent, values in pending.items():
        if parent not in containers:
            raise AssertionError(
                f"Path {parent!r} has children but no container entry "
                f"(entries: {list(manifest)})."
            )
        _attach(parent, containers[parent], values)
    return containers[prefix]


def _new_container(entry: Entry) -> Any:
    if isinstance(entry, ListEntry):
        return []
    if isinstance(entry, OrderedDictEntry):
        return OrderedDict.fromkeys(entry.keys)
    if isinstance(entry, DictEntry):
        # Pre-seeding with None preserves the original key order.
        return dict.fromkeys(entry.keys)
    raise RuntimeError(f"Not a container entry: {type(entry)} ({entry.type}).")


def _attach(path: str, container: Any, values: Dict[str, Any]) -> None:
    if isinstance(container, list):
        container.extend(v for _, v in sorted(values.items(), key=lambda kv: int(kv[0])))
        return
    if isinstance(container, dict):
        for raw_key, value in values.items():
            key: Any = _decode(raw_key)
            if key not in container and _looks_like_int(key):
                key = int(key)
            if key not in container:
                raise RuntimeError(
                    f"{key!r} is not a key of container {path!r} "
                    f"(keys: {list(container.keys())})."
                )
            container[key] = value
        return
    raise AssertionError(f"Unrecognized container type: {type(container)}.")


def _looks_like_int(s: str) -> bool:
    body = s[1:] if s[:1] in ("-", "+") and len(s) > 1 else s
    return body.isdigit()
