"""Write reference-format (TorchSnapshot 0.0.3) snapshots from torch state.

Counterpart of ``torchsnapshot_tpu/tricks/torchsnapshot_writer.py``: the
reverse of :mod:`.torchsnapshot_reader`, an escape hatch back to the
reference's tooling (evaluation scripts, checkpoint inspectors, a rollback
of the migration). What it writes restores through the reference library
and through both packages' readers.

A migration utility, not a second checkpointer: one process, world size
1, synchronous, no batching or partitioning; ``Snapshot.take`` stays the
production path. Format per the reference schema (entry taxonomy
``manifest.py:27-290``, flatten and percent-escaping ``flatten.py:204-211``,
dtype strings ``serialization.py:56-79``):

- tensors on the card or the CPU, and numpy arrays, become ``Tensor``
  entries, one leaf staged at a time. Dtypes in the reference's
  buffer-protocol set (f64/f32/f16/bf16/i64/i32/i16/i8/u8/bool) are raw
  little-endian bytes (numpy arrays of another byte order are swapped
  first); complex64/128, which the reference only round-trips through
  ``torch_save``, use that serializer. Dtypes the reference cannot
  represent at all (fp8, uint16/32/64) are rejected with a clear error
  rather than silently widened.
- a ``DTensor`` on a one-rank mesh is written as its ``full_tensor()``;
  one over more ranks is refused (this writer is world size 1).
- int/str/bool/bytes/float leaves become inline primitive entries (float
  in the reference's exact base64-packed form).
- anything else becomes an ``object`` entry through ``torch.save``.

The metadata is written as JSON (the JAX writer uses ``yaml.dump``). JSON
is a YAML subset, so the reference library and the JAX package's reader
load it with PyYAML, and writing it needs no PyYAML. The characters that
YAML 1.1 treats as line breaks or refuses in a stream are written as
``\\u`` escapes, so both parsers give the same document.

Usage::

    from torchsnapshot_tpu_torch.tricks.torchsnapshot_writer import (
        write_reference_snapshot,
    )

    write_reference_snapshot(
        "/ckpts/export_for_torch",
        {"model": model.state_dict(), "progress": {"step": 100}},
    )
    # reference side:  torchsnapshot.Snapshot(path).restore(app_state)
"""

from __future__ import annotations

import base64
import io
import json
import re
import struct
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..event_loop import run_in_fresh_event_loop
from ..flatten import flatten
from ..io_types import WriteIO
from ..manifest import DictEntry, ListEntry, OrderedDictEntry
from ..serialization import tensor_as_memoryview, tensor_from_numpy
from ..sharded_io_preparer import is_dtensor
from ..storage_plugin import url_to_storage_plugin

_METADATA_FNAME = ".snapshot_metadata"

# torch dtype -> reference dtype string, buffer-protocol subset
# (reference serialization.py:146-159: complex is NOT buffer-protocol
# there; it round-trips via torch_save).
_BUFFER_PROTOCOL_DTYPES: Dict[torch.dtype, str] = {
    torch.float64: "torch.float64",
    torch.float32: "torch.float32",
    torch.float16: "torch.float16",
    torch.bfloat16: "torch.bfloat16",
    torch.int64: "torch.int64",
    torch.int32: "torch.int32",
    torch.int16: "torch.int16",
    torch.int8: "torch.int8",
    torch.uint8: "torch.uint8",
    torch.bool: "torch.bool",
}
_TORCH_SAVE_DTYPES: Dict[torch.dtype, str] = {
    torch.complex128: "torch.complex128",
    torch.complex64: "torch.complex64",
}

# Characters a YAML 1.1 parser folds as line breaks (NEL, LS, PS) or
# refuses in a stream (C1 controls, DEL, the non-characters, BOM);
# ``json.dumps(ensure_ascii=False)`` leaves them raw.
_YAML_UNSAFE = re.compile("[\x7f-\x9f\u2028\u2029\ufeff\ufffe\uffff]")


def metadata_text(doc: Dict[str, Any]) -> str:
    """``doc`` as JSON that PyYAML's safe loader reads to the same
    document (``json.loads`` gives it too)."""
    text = json.dumps(doc, ensure_ascii=False)
    return _YAML_UNSAFE.sub(lambda m: "\\u%04x" % ord(m.group()), text)


def write_reference_snapshot(path: str, app_state: Dict[str, Any]) -> None:
    """Write ``app_state`` (``{key: nested value}``) as a world-size-1
    reference-format snapshot at ``path`` (a local path or URL)."""
    manifest: Dict[str, Any] = {}
    pending = []  # (logical_path, leaf), serialized one at a time below

    for key, value in app_state.items():
        containers, leaves = flatten(value, prefix=key)
        for cpath, centry in containers.items():
            manifest[f"0/{cpath}"] = _container_to_reference(centry)
        pending.extend(leaves.items())

    async def _go() -> None:
        storage = url_to_storage_plugin(path)
        try:
            # Serialize each leaf inside the loop and drop its bytes after
            # the write: peak host memory is one leaf, not the checkpoint.
            for lpath, leaf in pending:
                entry, blob = _prepare_leaf(lpath, leaf)
                manifest[f"0/{lpath}"] = entry
                if blob is not None:
                    await storage.write(WriteIO(path=path_location(lpath), buf=blob))
            doc = {"version": "0.0.3", "world_size": 1, "manifest": manifest}
            # Metadata last: its presence is the reference's commit marker.
            await storage.write(
                WriteIO(path=_METADATA_FNAME, buf=metadata_text(doc).encode("utf-8"))
            )
        finally:
            await storage.close()

    run_in_fresh_event_loop(_go())


def _container_to_reference(entry: Any) -> Dict[str, Any]:
    if isinstance(entry, ListEntry):
        return {"type": "list"}
    if isinstance(entry, OrderedDictEntry):
        return {"type": "OrderedDict", "keys": list(entry.keys)}
    if isinstance(entry, DictEntry):
        return {"type": "dict", "keys": list(entry.keys)}
    raise TypeError(f"unexpected container entry {entry!r}")


def _prepare_leaf(path: str, leaf: Any) -> Tuple[Dict[str, Any], Optional[Any]]:
    """Returns ``(manifest_entry, blob_or_None)``."""
    if isinstance(leaf, bool):  # before int: bool is an int subclass
        return _primitive("bool", str(leaf)), None
    if isinstance(leaf, int):
        return _primitive("int", str(leaf)), None
    if isinstance(leaf, float):
        packed = base64.b64encode(struct.pack("d", leaf)).decode("utf-8")
        return _primitive("float", packed, readable=str(leaf)), None
    if isinstance(leaf, str):
        return _primitive("str", leaf), None
    if isinstance(leaf, bytes):
        return _primitive("bytes", base64.b64encode(leaf).decode("utf-8")), None

    t = _as_tensor(path, leaf)
    if t is not None:
        return _tensor_entry(path, t)

    # Generic object -> torch_save pickle (the reference's object path).
    buf = io.BytesIO()
    torch.save(leaf, buf)
    entry = {
        "type": "object",
        "location": path_location(path),
        "serializer": "torch_save",
        "obj_type": type(leaf).__name__,
        "replicated": False,
    }
    return entry, buf.getvalue()


def path_location(path: str) -> str:
    return f"0/{path}"


def _as_tensor(path: str, leaf: Any) -> Optional[torch.Tensor]:
    """A dense CPU tensor for tensor, ``DTensor`` and numpy leaves; None
    for other leaves."""
    if is_dtensor(leaf):
        ranks = leaf.device_mesh.size()
        if ranks > 1:
            raise ValueError(
                f"leaf {path!r} is a DTensor over {ranks} ranks: write_reference_snapshot "
                f"writes world size 1 (as the JAX package's writer does); gather it with "
                f"full_tensor() on one process, or take a native snapshot with pg="
            )
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous().cpu()
    if isinstance(leaf, (np.ndarray, np.generic)):
        arr = np.asarray(leaf)
        # The reference format is raw LITTLE-endian bytes: a '>f4' array
        # (whose dtype.name is still 'float32') is swapped first.
        if arr.dtype.byteorder == ">" or (arr.dtype.byteorder == "=" and sys.byteorder == "big"):
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        try:
            return tensor_from_numpy(arr)
        except ValueError:
            raise _unrepresentable(path, arr.dtype.name) from None
    return None


def _unrepresentable(path: str, name: str) -> ValueError:
    return ValueError(
        f"dtype {name!r} (leaf {path!r}) has no representation in the "
        f"reference's format (its dtype table is fixed — reference "
        f"serialization.py:32-103); cast to a supported dtype first "
        f"(e.g. fp8 -> bfloat16, uint32 -> int64)"
    )


def _tensor_entry(path: str, t: torch.Tensor) -> Tuple[Dict[str, Any], Any]:
    entry = {
        "type": "Tensor",
        "location": path_location(path),
        "serializer": "buffer_protocol",
        "dtype": None,
        "shape": list(t.shape),
        "replicated": False,
        "byte_range": None,
    }
    if t.dtype in _BUFFER_PROTOCOL_DTYPES:
        entry["dtype"] = _BUFFER_PROTOCOL_DTYPES[t.dtype]
        return entry, tensor_as_memoryview(t)
    if t.dtype in _TORCH_SAVE_DTYPES:
        buf = io.BytesIO()
        torch.save(t, buf)
        entry["serializer"] = "torch_save"
        entry["dtype"] = _TORCH_SAVE_DTYPES[t.dtype]
        return entry, buf.getvalue()
    raise _unrepresentable(path, str(t.dtype).replace("torch.", ""))


def _primitive(kind: str, serialized: str, readable: Optional[str] = None) -> Dict[str, Any]:
    return {
        "type": kind,
        "serialized_value": serialized,
        "replicated": False,
        "readable": readable,
    }
