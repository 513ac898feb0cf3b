"""A plain reader of a committed snapshot directory on a local disk.

It follows the format as the files show it: ``.snapshot_metadata`` is a
JSON document whose ``manifest`` maps ``<rank>/<app key>/<path>`` to an
entry. Containers (``dict``, ``OrderedDict``, ``list``) hold no bytes.
An ``Array`` names a file under the snapshot (``location``), its dtype,
shape and an optional ``byte_range`` inside that file; a ``ChunkedArray``
lists such arrays as row blocks (``offsets``, ``sizes``); primitives are
inline (a float as ``float.hex``); an ``object`` is a pickle at its
location. Anything else is refused.
"""

from __future__ import annotations

import base64
import json
import os
import pickle
from typing import Any, Dict

import torch

DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
CONTAINERS = ("dict", "OrderedDict", "list")


def _read_bytes(snap: str, location: str, byte_range) -> bytes:
    with open(os.path.join(snap, location), "rb") as f:
        if byte_range is None:
            return f.read()
        start, end = byte_range
        f.seek(start)
        data = f.read(end - start)
    if len(data) != end - start:
        raise ValueError(f"{location}: short read of {byte_range}")
    return data


def _array(snap: str, e: Dict[str, Any]) -> torch.Tensor:
    dtype = DTYPES[e["dtype"]]
    raw = bytearray(_read_bytes(snap, e["location"], e.get("byte_range")))
    flat = torch.frombuffer(raw, dtype=torch.uint8) if raw else torch.empty(0, dtype=torch.uint8)
    return flat.view(dtype).reshape(e["shape"])


def _chunked(snap: str, e: Dict[str, Any]) -> torch.Tensor:
    out = torch.empty(e["shape"], dtype=DTYPES[e["dtype"]])
    for c in e["chunks"]:
        index = tuple(slice(o, o + s) for o, s in zip(c["offsets"], c["sizes"]))
        out[index] = _array(snap, c["array"])
    return out


def _primitive(e: Dict[str, Any]) -> Any:
    v = e["serialized_value"]
    kind = e["type"]
    if kind == "int":
        return int(v)
    if kind == "float":
        return float.fromhex(v)
    if kind == "bool":
        if v not in ("True", "False"):
            raise ValueError(f"bad bool {v!r}")
        return v == "True"
    if kind == "str":
        return v
    if kind == "bytes":
        return base64.b64decode(v)
    raise ValueError(kind)


def read_snapshot(snap: str, app_key: str, rank: int = 0) -> Dict[str, Any]:
    """Every leaf under ``<rank>/<app_key>/`` as ``{path: value}``: tensors on
    the CPU, primitives and unpickled objects as Python values."""
    with open(os.path.join(snap, ".snapshot_metadata")) as f:
        manifest = json.load(f)["manifest"]
    prefix = f"{rank}/{app_key}/"
    out: Dict[str, Any] = {}
    for key, e in manifest.items():
        if not key.startswith(prefix):
            continue
        path, kind = key[len(prefix):], e["type"]
        if kind in CONTAINERS:
            continue
        if kind == "Array":
            out[path] = _array(snap, e)
        elif kind == "ChunkedArray":
            out[path] = _chunked(snap, e)
        elif kind == "object":
            if e["serializer"] != "pickle":
                raise ValueError(f"{key}: unknown serializer {e['serializer']!r}")
            out[path] = pickle.loads(_read_bytes(snap, e["location"], None))
        elif kind in ("int", "float", "bool", "str", "bytes"):
            out[path] = _primitive(e)
        else:
            raise ValueError(f"{key}: entry type {kind!r} is not read by the reference")
    return out
