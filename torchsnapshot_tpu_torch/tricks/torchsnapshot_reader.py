"""Read snapshots written by the reference TorchSnapshot library onto the card.

Counterpart of ``torchsnapshot_tpu/tricks/torchsnapshot_reader.py``. Users
of the reference (``torchsnapshot==0.0.3``) carry checkpoints in its
on-disk format: a ``.snapshot_metadata`` manifest plus blob files. This
module reads that format directly and returns torch tensors on the
requested device (the card unless ``device="cpu"``) and Python values, so
a run resumes from an old checkpoint without the reference installed.

Format coverage (the reference's documented schema: entry taxonomy
reference ``manifest.py:27-290``, path grammar ``snapshot.py:897-900``,
percent-escaping ``flatten.py:204-211``), as in the JAX package:

- ``Tensor`` entries, both serializers: ``buffer_protocol`` (raw
  little-endian bytes, built into a tensor through a ``uint8`` view, bf16
  included) and ``torch_save`` (``torch.load`` on the CPU, then moved).
- ``ShardedTensor`` / ``ChunkedTensor``: shards or chunks assembled into
  one dense tensor (offsets/sizes boxes; the global shape from the entry
  for chunked, the shard envelope for sharded); holes raise.
- ``object`` entries (``torch_save`` pickles): returned as loaded, with
  every torch tensor inside moved to the device. The JAX package turns
  them into numpy arrays; here they stay torch tensors.
- Inline primitives (int/str/bool/bytes/float, float from its
  base64-packed exact form, reference ``manifest.py:263-265``).
- Containers (dict/OrderedDict/list) inflated back into nested
  structures, with int-key recovery and percent-decoding.
- ``byte_range`` blob windows (batched slabs, reference ``batcher.py:173``)
  through ranged storage reads.
- Rank availability rules (reference ``manifest.py:333-371``): per-rank
  entries of the requested rank, replicated entries from any rank,
  ShardedTensor shards merged across all ranks.

The metadata parses as JSON first (what this package's and the JAX
package's writers emit), then with PyYAML's safe loader, which is
imported only for a YAML document and named in the error if missing.

Not supported (never produced by the reference either: its quantized
tensors serialize via ``torch_save``): the ``per_tensor_qtensor`` /
``per_channel_qtensor`` serializers; reading one raises with that
explanation.

Usage::

    from torchsnapshot_tpu_torch.tricks.torchsnapshot_reader import (
        ReferenceSnapshotReader,
    )

    reader = ReferenceSnapshotReader("/path/to/old/snapshot")
    state = reader.read_state(rank=0)           # tensors on the card
    w = reader.read_object("0/model/lin.weight")
    dt = reader.read_sharded("0/model/emb", (mesh, [Shard(0)]))  # a DTensor
"""

from __future__ import annotations

import asyncio
import base64
import io
import json
import math
import struct
import warnings
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..flatten import _decode, _looks_like_int
from ..io_types import ReadIO
from ..manifest import _load_yaml
from ..storage_plugin import url_to_storage_plugin
from ..utils.device import Device, resolve_device

_METADATA_FNAME = ".snapshot_metadata"

# The reference persists dtypes as "torch.<name>" strings (its
# serialization.py dtype table).
_TORCH_DTYPE_STRINGS: Dict[str, torch.dtype] = {
    "torch.float64": torch.float64,
    "torch.float32": torch.float32,
    "torch.float16": torch.float16,
    "torch.bfloat16": torch.bfloat16,
    "torch.complex128": torch.complex128,
    "torch.complex64": torch.complex64,
    "torch.int64": torch.int64,
    "torch.int32": torch.int32,
    "torch.int16": torch.int16,
    "torch.int8": torch.int8,
    "torch.uint8": torch.uint8,
    "torch.bool": torch.bool,
}

_PRIMITIVE_TYPES = ("int", "str", "bool", "bytes", "float")
_CONTAINER_TYPES = ("list", "dict", "OrderedDict")


def torch_dtype(torch_dtype_str: str) -> torch.dtype:
    try:
        return _TORCH_DTYPE_STRINGS[torch_dtype_str]
    except KeyError:
        raise ValueError(
            f"unsupported reference dtype string {torch_dtype_str!r} "
            f"(quantized dtypes have no dense equivalent)"
        ) from None


def _primitive_value(entry: Dict[str, Any]) -> Any:
    """Decode an inline primitive entry (reference manifest.py:195-290)."""
    kind = entry["type"]
    raw = entry["serialized_value"]
    if kind == "int":
        return int(raw)
    if kind == "str":
        return raw
    if kind == "bool":
        if raw not in ("True", "False"):
            raise ValueError(f"malformed bool primitive: {raw!r}")
        return raw == "True"
    if kind == "bytes":
        return base64.b64decode(raw.encode("utf-8"))
    if kind == "float":
        # Exact round-trip: the reference packs the double and base64s it.
        return struct.unpack("d", base64.b64decode(raw.encode("utf-8")))[0]
    raise ValueError(f"not a primitive entry type: {kind!r}")


def _entry_boxes(entry: Dict[str, Any]):
    """Normalize a tensor-bearing entry into
    ``([(offsets, sizes, tensor_entry)], global_shape, dtype)``.

    For ShardedTensor the global shape is the shard envelope (the entry
    records no global shape); ChunkedTensor and Tensor declare theirs.
    One definition shared by the dense ``_assemble`` path and
    ``read_sharded``, so envelope and dtype inference cannot diverge."""
    kind = entry.get("type")
    if kind == "Tensor":
        shape = tuple(int(d) for d in entry["shape"])
        return [(tuple(0 for _ in shape), shape, entry)], shape, torch_dtype(entry["dtype"])
    if kind in ("ShardedTensor", "ChunkedTensor"):
        raw = entry["shards"] if kind == "ShardedTensor" else entry["chunks"]
        if not raw:
            raise ValueError("entry has no shards/chunks")
        boxes = [
            (
                tuple(int(o) for o in b["offsets"]),
                tuple(int(s) for s in b["sizes"]),
                b["tensor"],
            )
            for b in raw
        ]
        if kind == "ChunkedTensor":
            shape = tuple(int(d) for d in entry["shape"])
            dtype = torch_dtype(entry["dtype"])
        else:
            ndim = len(boxes[0][0])
            shape = tuple(max(o[d] + s[d] for o, s, _ in boxes) for d in range(ndim))
            dtype = torch_dtype(boxes[0][2]["dtype"])
        return boxes, shape, dtype
    raise ValueError(f"entry type {kind!r} is not a tensor entry")


def _host_tensor(data: memoryview, dtype: torch.dtype, shape: Tuple[int, ...]) -> torch.Tensor:
    """A CPU tensor over a read buffer's bytes: aliased when the buffer is
    writable, else copied (a tensor must not alias read-only memory)."""
    raw = np.frombuffer(data, dtype=np.uint8)
    if not raw.flags.writeable:
        raw = raw.copy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(raw)
    return t.view(dtype).reshape(shape)


def _to_device(obj: Any, device: torch.device) -> Any:
    """Torch tensors anywhere in a loaded object moved to ``device``
    (quantized ones dequantized first, as the JAX package's numpy
    conversion does); everything else passes through."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.is_quantized:
            t = t.dequantize()
        return t.to(device)
    if isinstance(obj, dict):
        return type(obj)((k, _to_device(v, device)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


def _parse_metadata(text: str) -> Any:
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return _load_yaml(text)


@dataclass
class ReadStats:
    """What a reader has fetched: ranged reads (byte windows of a blob),
    of them those that landed straight in their destination, whole-blob
    reads, their bytes, and the most host bytes one ``read_sharded`` held
    at once (its local box, coverage mask and source buffers)."""

    ranged_reads: int = 0
    direct_reads: int = 0
    whole_reads: int = 0
    bytes_read: int = 0
    peak_host_bytes: int = 0


class ReferenceSnapshotReader:
    """Random and bulk access to a reference-format snapshot.

    ``path`` accepts the same URL grammar as the rest of this package
    (bare paths are the local filesystem; ``memory://``). ``device`` is
    where tensors land: the card unless ``"cpu"`` is given.

    The storage plugin and its event loop are created lazily on first
    read and reused for the reader's lifetime; ``close()`` releases them,
    and the reader works as a context manager.
    """

    def __init__(self, path: str, device: Device = None) -> None:
        self.path = path
        self.device = resolve_device(device)
        self.stats = ReadStats()
        self._metadata: Optional[Dict[str, Any]] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._storage: Optional[Any] = None

    def close(self) -> None:
        if self._loop is not None:
            loop, storage = self._loop, self._storage
            self._loop = self._storage = None
            try:
                if storage is not None:
                    loop.run_until_complete(storage.close())
            finally:
                loop.close()

    def __enter__(self) -> "ReferenceSnapshotReader":
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.close()

    def __del__(self) -> None:  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter-shutdown noise
            pass

    # -- metadata ------------------------------------------------------

    @property
    def metadata(self) -> Dict[str, Any]:
        """The parsed ``.snapshot_metadata`` document:
        ``{"version": str, "world_size": int, "manifest": {path: entry}}``,
        entries as plain dicts (the YAML form is the format contract,
        reference manifest.py:32-35)."""
        if self._metadata is None:
            raw = self._read_blob(_METADATA_FNAME, None)
            doc = _parse_metadata(bytes(raw).decode("utf-8"))
            if not isinstance(doc, dict) or "manifest" not in doc:
                raise ValueError(
                    f"{self.path}/{_METADATA_FNAME} is not a TorchSnapshot metadata document"
                )
            self._metadata = doc
        return self._metadata

    @property
    def world_size(self) -> int:
        return int(self.metadata.get("world_size", 1))

    def manifest_for_rank(self, rank: int) -> Dict[str, Any]:
        """Logical-path -> entry view for ``rank`` under the reference's
        availability rules (manifest.py:333-371): the rank's own entries,
        replicated entries from every rank, and ShardedTensor entries
        merged across ranks (shards sorted by offsets)."""
        own: Dict[str, Any] = {}
        others: List[Tuple[int, str, Dict[str, Any]]] = []
        for path, entry in self.metadata["manifest"].items():
            rnk_str, _, logical = path.partition("/")
            rnk = int(rnk_str)
            if rnk == rank:
                own[logical] = dict(entry)
            else:
                others.append((rnk, logical, entry))
        for _, logical, entry in others:
            if entry.get("type") == "ShardedTensor":
                if logical in own and own[logical].get("type") == "ShardedTensor":
                    merged = own[logical]["shards"] + entry["shards"]
                    own[logical] = {
                        "type": "ShardedTensor",
                        "shards": sorted(merged, key=lambda s: s["offsets"]),
                    }
                elif logical not in own:
                    own[logical] = dict(entry)
            elif entry.get("replicated") and logical not in own:
                own[logical] = dict(entry)
        # Container chains for adopted entries: a replicated or sharded
        # leaf from another rank needs its ancestor containers present for
        # inflation; adopt them (keys pruned to adopted children at
        # population time, so stale keys are harmless).
        by_rank: Dict[int, Dict[str, Any]] = {}
        for rnk, logical, entry in others:
            by_rank.setdefault(rnk, {})[logical] = entry
        for logical in list(own):
            parts = logical.split("/")
            for i in range(1, len(parts)):
                parent = "/".join(parts[:i])
                if parent in own:
                    continue
                for manifest in by_rank.values():
                    p = manifest.get(parent)
                    if p is not None and p.get("type") in _CONTAINER_TYPES:
                        own[parent] = dict(p)
                        break
        return own

    # -- reads ---------------------------------------------------------

    def _split(self, path: str, rank: Optional[int]) -> Tuple[int, str]:
        if rank is None:
            rank_str, _, logical = path.partition("/")
            return int(rank_str), logical
        return rank, path

    def read_object(self, path: str, rank: Optional[int] = None) -> Any:
        """Read one manifest path. ``path`` is the reference's
        ``read_object`` grammar: ``"RANK/logical/path"`` (rank prefix
        optional when ``rank`` is given)."""
        rank, logical = self._split(path, rank)
        manifest = self.manifest_for_rank(rank)
        if logical not in manifest:
            raise KeyError(
                f"{logical!r} not in the rank-{rank} manifest "
                f"(available: {sorted(manifest)[:10]}...)"
            )
        return self._materialize(manifest[logical])

    def read_state(self, rank: int = 0) -> Dict[str, Any]:
        """The full app state visible to ``rank`` as one nested structure,
        ``{app_state_key: nested value}``: what the reference's
        ``restore`` would hand each stateful's ``load_state_dict``."""
        manifest = self.manifest_for_rank(rank)
        leaves = {
            p: self._materialize(e)
            for p, e in manifest.items()
            if e.get("type") not in _CONTAINER_TYPES
        }
        return self._inflate(manifest, leaves)

    def read_sharded(
        self,
        path: str,
        sharding: Any,
        rank: Optional[int] = None,
        global_shape: Optional[Tuple[int, ...]] = None,
    ) -> Any:
        """Place one tensor entry directly into a ``DTensor``.

        ``sharding`` is a ``(DeviceMesh, placements)`` pair or a template
        ``DTensor`` whose mesh and placements are used, as the port's
        ``Snapshot.read_object(sharding=)`` takes it. This process builds
        only its own box of the array (torch's ``Shard`` chunking,
        ``resharding.target_boxes_for_placements``) from the persisted
        shards that overlap it, so the full tensor is never materialized
        on the host: peak host memory is the local box plus the
        overlapping source pieces. Overlaps that are row slabs of a
        buffer-protocol shard arrive as ranged reads of just those rows
        (``resharding.row_slab_byte_window``). The box is copied to the
        mesh's device once and wrapped by ``DTensor.from_local``. Accepts
        ``Tensor``, ``ShardedTensor`` and ``ChunkedTensor`` entries, under
        any layout (resharding on read). ``path``/``rank`` name the entry
        as in :meth:`read_object`; the mesh's ranks need not match the
        snapshot's.

        ``global_shape``: pass the expected full shape when known. A
        ``ShardedTensor`` entry records no global shape (it is inferred
        as the shard envelope), so a snapshot missing its tail shards
        would silently infer a smaller array; an explicit shape turns
        that into a loud shard-coverage error.
        """
        from torch.distributed.tensor import DTensor

        from ..resharding import Box, box_overlap, row_slab_byte_window, target_boxes_for_placements
        from ..sharded_io_preparer import _contiguous_stride, mesh_and_placements

        mesh, placements = mesh_and_placements(sharding)
        rank, logical = self._split(path, rank)
        manifest = self.manifest_for_rank(rank)
        if logical not in manifest:
            raise KeyError(f"{logical!r} not in the rank-{rank} manifest")
        raw_boxes, shape, dtype = _entry_boxes(manifest[logical])
        # Dedup identical persisted boxes (a DP-replicated checkpoint can
        # record the same shard box from several ranks).
        seen = set()
        boxes = []
        for offsets, sizes, tentry in raw_boxes:
            if (offsets, sizes) not in seen:
                seen.add((offsets, sizes))
                boxes.append((Box(offsets, sizes), tentry))
        if global_shape is not None:
            global_shape = tuple(int(d) for d in global_shape)
            if len(global_shape) != len(shape) or any(g < s for g, s in zip(global_shape, shape)):
                raise ValueError(
                    f"{logical!r}: global_shape {global_shape} is "
                    f"incompatible with the persisted extent {shape}"
                )
            shape = global_shape

        targets = target_boxes_for_placements(mesh, placements, shape)
        if not targets:
            raise ValueError("this rank is not part of the target device mesh")
        (dst_box,) = targets

        def _row_range(i: int, ov) -> Optional[Tuple[int, int]]:
            """The byte window of an overlap's rows in source blob ``i``,
            composed with any byte_range the entry already has (batched
            slabs), when the overlap is a row slab of a raw little-endian
            shard; the window math is the shared slab geometry the native
            restore ranges with."""
            sbox, tentry = boxes[i]
            if tentry.get("serializer") != "buffer_protocol":
                return None
            row_bytes = torch_dtype(tentry["dtype"]).itemsize
            for d in range(1, sbox.ndim):
                row_bytes *= sbox.sizes[d]
            base = tentry.get("byte_range")
            base = int(base[0]) if base else 0
            return row_slab_byte_window(sbox.sizes, ov, row_bytes, base)

        plan = []
        for i, (sbox, _) in enumerate(boxes):
            ov = box_overlap(sbox, dst_box)
            if ov is not None:
                plan.append((i, ov, _row_range(i, ov)))

        on_card = mesh.device_type == "cuda"
        # A pinned host box for a card mesh: its one copy to the card is a
        # DMA, as the native sharded restore stages it.
        local = torch.empty(dst_box.sizes, dtype=dtype, pin_memory=on_card)
        covered = torch.zeros(dst_box.sizes, dtype=torch.bool)
        held = local.nbytes + covered.nbytes

        def _window(ov) -> Optional[memoryview]:
            """The bytes of the local box an overlap fills, when they are
            contiguous (the overlap spans the box's trailing dims): a
            ranged read lands there directly, with no buffer between."""
            for d in range(1, len(dst_box.sizes)):
                if ov.dst_slices[d] != slice(0, dst_box.sizes[d]):
                    return None
            return memoryview(local[ov.dst_slices].reshape(-1).view(torch.uint8).numpy())

        # All of the box's ranged windows fetch concurrently.
        ranged = [(i, ov, rng, _window(ov)) for i, ov, rng in plan if rng is not None]
        datas = (
            self._read_blobs([(boxes[i][1]["location"], rng) for i, _, rng, _ in ranged], [w for *_, w in ranged])
            if ranged
            else []
        )
        self._note_host_bytes(held + sum(len(d) for d, (*_, w) in zip(datas, ranged) if d is not w))
        for (i, ov, rng, window), data in zip(ranged, datas):
            sbox, tentry = boxes[i]
            if len(data) != rng[1] - rng[0]:
                raise ValueError(
                    f"blob {tentry['location']!r} returned {len(data)} "
                    f"bytes for window [{rng[0]}, {rng[1]}) — blob is "
                    f"shorter than the manifest claims"
                )
            if data is not window:
                r = ov.src_slices[0]
                sub = _host_tensor(data, torch_dtype(tentry["dtype"]), (r.stop - r.start,) + tuple(sbox.sizes[1:]))
                local[ov.dst_slices] = sub
            covered[ov.dst_slices] = True
        del datas
        for i, ov, rng in plan:
            if rng is not None:
                continue
            sbox, tentry = boxes[i]
            piece = self._read_tensor(tentry, torch.device("cpu")).reshape(sbox.sizes)
            self._note_host_bytes(held + piece.nbytes)
            local[ov.dst_slices] = piece[ov.src_slices]
            covered[ov.dst_slices] = True
            del piece
        if not bool(covered.all()):
            raise ValueError(
                f"{logical!r}: persisted shards cover only "
                f"{int(covered.sum())} of {dst_box.numel()} elements of "
                f"a destination shard — the snapshot's shard set has "
                f"holes"
            )
        del covered
        if on_card:
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device(mesh.device_type)
        return DTensor.from_local(
            local.to(device), mesh, placements, run_check=False,
            shape=torch.Size(shape), stride=_contiguous_stride(shape),
        )

    # -- internals -----------------------------------------------------

    def _note_host_bytes(self, n: int) -> None:
        self.stats.peak_host_bytes = max(self.stats.peak_host_bytes, int(n))

    def _read_blob(self, location: str, byte_range: Optional[Tuple[int, int]]) -> memoryview:
        return self._read_blobs([(location, byte_range)])[0]

    def _read_blobs(
        self,
        requests: List[Tuple[str, Optional[Tuple[int, int]]]],
        dests: Optional[List[Optional[memoryview]]] = None,
    ) -> List[memoryview]:
        """Issue several reads concurrently in the reader's event loop:
        one gather, not len(requests) sequential round trips. A read with
        a ``dests`` entry may land in it (its buffer is then that very
        object)."""
        if self._loop is None:
            self._loop = asyncio.new_event_loop()
            self._storage = url_to_storage_plugin(self.path)
        dests = dests or [None] * len(requests)

        async def _go() -> List[memoryview]:
            ios = [ReadIO(path=loc, byte_range=br, dest=d) for (loc, br), d in zip(requests, dests)]
            await asyncio.gather(*(self._storage.read(io) for io in ios))
            for io in ios:
                # Explicit (not an assert): the check must survive
                # ``python -O``.
                if io.buf is None:
                    raise RuntimeError(
                        f"storage plugin "
                        f"{type(self._storage).__name__} completed read() "
                        f"without populating the buffer for {io.path!r}"
                    )
            return [io.buf for io in ios]

        bufs = self._loop.run_until_complete(_go())
        for (loc, br), buf, dest in zip(requests, bufs, dests):
            if loc == _METADATA_FNAME:
                continue
            if br is None:
                self.stats.whole_reads += 1
            else:
                self.stats.ranged_reads += 1
                self.stats.direct_reads += buf is dest
            self.stats.bytes_read += memoryview(buf).nbytes
        return bufs

    def _materialize(self, entry: Dict[str, Any]) -> Any:
        kind = entry.get("type")
        if kind in _PRIMITIVE_TYPES:
            return _primitive_value(entry)
        if kind == "Tensor":
            return self._read_tensor(entry, self.device)
        if kind in ("ShardedTensor", "ChunkedTensor"):
            return self._assemble(entry)
        if kind == "object":
            return self._read_torch_object(entry)
        raise ValueError(f"cannot materialize entry type {kind!r}")

    def _read_tensor(self, entry: Dict[str, Any], device: torch.device) -> torch.Tensor:
        byte_range = entry.get("byte_range")
        if byte_range is not None:
            byte_range = (int(byte_range[0]), int(byte_range[1]))
        data = self._read_blob(entry["location"], byte_range)
        serializer = entry["serializer"]
        shape = tuple(int(d) for d in entry["shape"])
        if serializer == "buffer_protocol":
            dtype = torch_dtype(entry["dtype"])
            need = dtype.itemsize * math.prod(shape)
            if len(data) != need:
                hint = ""
                if len(data) == 0 and shape == () and entry["dtype"] == "torch.bfloat16":
                    # Reference bug, verified against it directly: its 0-d
                    # bf16 zero-copy path (serialization.py:216-233) writes
                    # an EMPTY blob, and its own restore fails on it too:
                    # the value was destroyed at save time.
                    hint = (
                        " (known reference bug: 0-d bfloat16 tensors are "
                        "saved as empty blobs and are unrecoverable — the "
                        "reference's own restore fails on them as well)"
                    )
                raise ValueError(
                    f"blob {entry['location']!r} holds {len(data)} bytes "
                    f"but entry dtype={entry['dtype']} shape={list(shape)} "
                    f"needs {need}{hint}"
                )
            return _host_tensor(data, dtype, shape).to(device)
        if serializer == "torch_save":
            return _to_device(self._torch_load(data), device).reshape(shape)
        raise NotImplementedError(
            f"serializer {serializer!r} is not supported: the reference "
            f"defines the qtensor codecs but never emits them (its "
            f"quantized tensors serialize via torch_save — reference "
            f"serialization.py:148-159)"
        )

    def _assemble(self, entry: Dict[str, Any]) -> torch.Tensor:
        """Assemble a sharded or chunked entry's boxes into one dense
        tensor on the reader's device (``read_sharded`` is the
        bounded-memory alternative). Interior holes in the shard set raise
        instead of silently zero-filling: zeros here would convert into
        corrupt-but-valid native snapshots downstream (convert.py reads
        through this path)."""
        boxes, shape, dtype = _entry_boxes(entry)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        covered = torch.zeros(shape, dtype=torch.bool)
        for offsets, sizes, tentry in boxes:
            piece = self._read_tensor(tentry, self.device).reshape(sizes)
            window = tuple(slice(o, o + s) for o, s in zip(offsets, sizes))
            out[window] = piece
            covered[window] = True
        if not bool(covered.all()):
            raise ValueError(
                f"persisted shards cover only {int(covered.sum())} of "
                f"{out.numel()} elements of a "
                f"{entry.get('type', 'sharded')} entry — the snapshot's "
                f"shard set has holes"
            )
        return out

    def _read_torch_object(self, entry: Dict[str, Any]) -> Any:
        data = self._read_blob(entry["location"], None)
        return _to_device(self._torch_load(data), self.device)

    def _torch_load(self, data: memoryview) -> Any:
        # weights_only=False: torch>=2.6 flipped the default, which
        # rejects numpy payloads and user classes, the very things the
        # reference pickles into object entries. This reads the user's
        # OWN checkpoint (same trust model as the reference-era
        # torch.load), so full unpickling is the correct behavior here.
        return torch.load(io.BytesIO(bytes(data)), map_location="cpu", weights_only=False)

    def _inflate(self, manifest: Dict[str, Any], leaves: Dict[str, Any]) -> Dict[str, Any]:
        """Rebuild the nested structure from container entries and leaf
        values (the reference's inflate semantics: list order by int
        index, dict keys percent-decoded with int recovery)."""
        missing = object()  # placeholder: distinguishes "not loaded" from None
        containers: Dict[str, Any] = {}
        for path, entry in manifest.items():
            kind = entry.get("type")
            if kind == "list":
                containers[path] = []
            elif kind in ("dict", "OrderedDict"):
                # Pre-seed with the entry's recorded keys: preserves the
                # original item order and native int keys (reference
                # flatten.py:157-162). Keys with nothing available for
                # this rank are pruned after population.
                cls = OrderedDict if kind == "OrderedDict" else dict
                containers[path] = cls((k, missing) for k in entry.get("keys", []))
        root: Dict[str, Any] = {}

        def _place(path: str, value: Any) -> None:
            parent, _, key = path.rpartition("/")
            key = _decode(key)
            if not parent:
                root[key] = value
                return
            container = containers.get(parent)
            if container is None:
                # Parent container entry missing (partial manifests):
                # surface the leaf under its full path instead of dropping.
                root[path] = value
                return
            if isinstance(container, list):
                container.append((int(key), value))
            else:
                if key not in container and _looks_like_int(key):
                    key = int(key)
                container[key] = value

        # Containers first, deepest first, so leaf placement always finds
        # its parent; then leaves in any order.
        for path in sorted(containers, key=lambda p: -p.count("/")):
            _place(path, containers[path])
        for path, value in leaves.items():
            _place(path, value)

        # Settle only the containers THIS inflater created (tracked by
        # identity): our lists hold (index, value) pairs to order, our
        # dicts hold placeholder keys to prune. A list or dict arriving
        # as a leaf VALUE (e.g. inside a pickled object entry) is user
        # data and must pass through untouched.
        container_ids = {id(c) for c in containers.values()}

        def _settle(obj: Any) -> Any:
            if id(obj) not in container_ids:
                return obj
            if isinstance(obj, list):
                return [_settle(v) for _, v in sorted(obj, key=lambda e: e[0])]
            for k in [k for k, v in obj.items() if v is missing]:
                del obj[k]
            for k, v in obj.items():
                obj[k] = _settle(v)
            return obj

        return {k: _settle(v) for k, v in root.items()}


def read_reference_snapshot(path: str, rank: int = 0, device: Device = None) -> Dict[str, Any]:
    """One-call convenience: the full nested state visible to ``rank``,
    tensors on ``device`` (the card by default)."""
    with ReferenceSnapshotReader(path, device=device) as reader:
        return reader.read_state(rank=rank)
