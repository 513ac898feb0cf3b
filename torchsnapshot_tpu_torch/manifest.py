"""Snapshot metadata schema: entry taxonomy, YAML/JSON codec, per-rank views.

Reference parity: torchsnapshot/manifest.py. Entries are tagged unions of
primitive YAML types; backward/forward compatibility is defined on the YAML
form, not on the Python dataclasses (reference: manifest.py:32-35). Tags:

- ``Array`` / ``ShardedArray`` / ``ChunkedArray`` — the jax.Array analogs of
  the reference's Tensor/ShardedTensor/ChunkedTensor (manifest.py:40-151)
- ``object`` — pickled opaque leaves (manifest.py:154-168)
- ``list`` / ``dict`` / ``OrderedDict`` — container structure (:171-192)
- ``int``/``float``/``str``/``bool``/``bytes`` — primitives stored inline in
  the metadata itself (:195-290); floats carry an exact ``float.hex()``
  encoding next to a human-readable repr.

Global manifest keys are ``"{rank}/{logical_path}"``; storage locations are
``sharded/...``, ``replicated/...``, ``{rank}/...`` and ``batched/{uuid}``.

Counterpart of ``torchsnapshot_tpu/manifest.py``. The metadata file is
written as JSON, the form the JAX package commits and reads first
(``SnapshotMetadata.from_yaml``). JSON is a YAML subset, so YAML tooling
still reads it; PyYAML is imported only to read a manifest that is not
JSON.
"""

from __future__ import annotations

import base64
import copy
import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union
from urllib.parse import unquote as _unquote



@dataclass
class Entry:
    """Base of all manifest entries; ``type`` is the YAML tag."""

    type: str


_FROM_YAML: Dict[str, Callable[[Dict[str, Any]], "Entry"]] = {}


def _register(tag: str):
    def deco(fn):
        _FROM_YAML[tag] = fn
        return fn

    return deco


@dataclass(init=False)
class ArrayEntry(Entry):
    """A dense array persisted at ``location`` (reference TensorEntry,
    manifest.py:40-72). ``byte_range`` is set when the bytes live inside a
    batched slab or a subdivided shard file. ``digest`` is an optional
    content digest of the payload (ops/device_digest.py format) recorded
    by digest-enabled takes; incremental takes compare against it to skip
    rewriting unchanged chunks. A ``location`` may be *snapshot-relative
    with parent refs* (``../step_.../...``) when the bytes live in a base
    snapshot this one was taken incrementally against."""

    location: str
    serializer: str
    dtype: str
    shape: List[int]
    replicated: bool
    byte_range: Optional[List[int]]
    digest: Optional[str]

    def __init__(
        self,
        location: str,
        serializer: str,
        dtype: str,
        shape: List[int],
        replicated: bool,
        byte_range: Optional[List[int]] = None,
        digest: Optional[str] = None,
    ) -> None:
        super().__init__(type="Array")
        self.location = location
        self.serializer = serializer
        self.dtype = dtype
        self.shape = list(shape)
        self.replicated = replicated
        self.byte_range = list(byte_range) if byte_range is not None else None
        self.digest = digest

    @property
    def byte_range_tuple(self) -> Optional[Tuple[int, int]]:
        if self.byte_range is None:
            return None
        return (self.byte_range[0], self.byte_range[1])


@_register("Array")
def _array_from_yaml(obj: Dict[str, Any]) -> ArrayEntry:
    return ArrayEntry(
        location=obj["location"],
        serializer=obj["serializer"],
        dtype=obj["dtype"],
        shape=obj["shape"],
        replicated=obj["replicated"],
        byte_range=obj.get("byte_range"),
        digest=obj.get("digest"),
    )


@dataclass
class Shard:
    """A hyper-rectangular piece of a logical array: N-d ``offsets`` +
    ``sizes`` plus the dense entry holding its bytes (reference
    manifest.py:75-79)."""

    offsets: List[int]
    sizes: List[int]
    array: ArrayEntry

    @classmethod
    def from_yaml(cls, obj: Dict[str, Any]) -> "Shard":
        return cls(
            offsets=list(obj["offsets"]),
            sizes=list(obj["sizes"]),
            array=_array_from_yaml(obj["array"]),
        )


@dataclass(init=False)
class ShardedArrayEntry(Entry):
    """An array partitioned across processes by its GSPMD sharding; shards
    from all ranks are merged into one entry on restore (reference
    ShardedTensorEntry, manifest.py:82-107). ``shape``/``dtype`` describe
    the full logical array — needed to allocate a differently-sharded
    destination when resharding elastically."""

    dtype: str
    shape: List[int]
    shards: List[Shard]

    def __init__(self, dtype: str, shape: List[int], shards: List[Shard]) -> None:
        super().__init__(type="ShardedArray")
        self.dtype = dtype
        self.shape = list(shape)
        self.shards = shards


@_register("ShardedArray")
def _sharded_from_yaml(obj: Dict[str, Any]) -> ShardedArrayEntry:
    return ShardedArrayEntry(
        dtype=obj["dtype"],
        shape=obj["shape"],
        shards=[Shard.from_yaml(s) for s in obj["shards"]],
    )


@dataclass(init=False)
class ChunkedArrayEntry(Entry):
    """A large *unsharded* array split into chunks so staging/writes stream
    under the memory budget (reference ChunkedTensorEntry,
    manifest.py:110-151)."""

    dtype: str
    shape: List[int]
    chunks: List[Shard]
    replicated: bool

    def __init__(
        self, dtype: str, shape: List[int], chunks: List[Shard], replicated: bool
    ) -> None:
        super().__init__(type="ChunkedArray")
        self.dtype = dtype
        self.shape = list(shape)
        self.chunks = chunks
        self.replicated = replicated


@_register("ChunkedArray")
def _chunked_from_yaml(obj: Dict[str, Any]) -> ChunkedArrayEntry:
    return ChunkedArrayEntry(
        dtype=obj["dtype"],
        shape=obj["shape"],
        chunks=[Shard.from_yaml(c) for c in obj["chunks"]],
        replicated=obj["replicated"],
    )


@dataclass(init=False)
class ObjectEntry(Entry):
    """A pickled opaque leaf (reference manifest.py:154-168)."""

    location: str
    serializer: str
    obj_type: str
    replicated: bool

    def __init__(
        self, location: str, serializer: str, obj_type: str, replicated: bool
    ) -> None:
        super().__init__(type="object")
        self.location = location
        self.serializer = serializer
        self.obj_type = obj_type
        self.replicated = replicated


@_register("object")
def _object_from_yaml(obj: Dict[str, Any]) -> ObjectEntry:
    return ObjectEntry(
        location=obj["location"],
        serializer=obj["serializer"],
        obj_type=obj["obj_type"],
        replicated=obj["replicated"],
    )


@dataclass(init=False)
class ListEntry(Entry):
    def __init__(self) -> None:
        super().__init__(type="list")


_FROM_YAML["list"] = lambda obj: ListEntry()


@dataclass(init=False)
class DictEntry(Entry):
    keys: List[Union[str, int]]

    def __init__(self, keys: List[Union[str, int]]) -> None:
        super().__init__(type="dict")
        self.keys = list(keys)


_FROM_YAML["dict"] = lambda obj: DictEntry(keys=obj["keys"])


@dataclass(init=False)
class OrderedDictEntry(Entry):
    keys: List[Union[str, int]]

    def __init__(self, keys: List[Union[str, int]]) -> None:
        super().__init__(type="OrderedDict")
        self.keys = list(keys)


_FROM_YAML["OrderedDict"] = lambda obj: OrderedDictEntry(keys=obj["keys"])


PRIMITIVE_TYPE_NAMES: Tuple[str, ...] = ("int", "float", "str", "bool", "bytes")


@dataclass(init=False)
class PrimitiveEntry(Entry):
    """A primitive value stored inline in the metadata (reference
    manifest.py:195-290). ``serialized_value`` is exact (``float.hex()`` for
    floats, base64 for bytes); ``readable`` is a best-effort human-friendly
    rendering."""

    serialized_value: str
    replicated: bool
    readable: Optional[str]

    def __init__(
        self,
        type: str,
        serialized_value: str,
        replicated: bool,
        readable: Optional[str] = None,
    ) -> None:
        super().__init__(type=type)
        self.serialized_value = serialized_value
        self.replicated = replicated
        self.readable = readable

    @classmethod
    def from_object(cls, obj: Any, replicated: bool = False) -> "PrimitiveEntry":
        type_name = type(obj).__name__
        if type_name == "int":
            return cls("int", str(obj), replicated)
        if type_name == "bool":
            return cls("bool", str(obj), replicated)
        if type_name == "str":
            return cls("str", obj, replicated)
        if type_name == "bytes":
            return cls("bytes", base64.b64encode(obj).decode("ascii"), replicated)
        if type_name == "float":
            return cls("float", float(obj).hex(), replicated, readable=repr(obj))
        raise TypeError(f"Unsupported primitive type: {type_name}")

    def get_value(self) -> Union[int, float, str, bool, bytes]:
        if self.type == "int":
            return int(self.serialized_value)
        if self.type == "bool":
            if self.serialized_value not in ("True", "False"):
                raise RuntimeError(
                    f"Corrupt bool serialized_value: {self.serialized_value!r}"
                )
            return self.serialized_value == "True"
        if self.type == "str":
            return self.serialized_value
        if self.type == "bytes":
            return base64.b64decode(self.serialized_value.encode("ascii"))
        if self.type == "float":
            return float.fromhex(self.serialized_value)
        raise ValueError(f"Not a primitive entry type: {self.type}")


def _primitive_from_yaml(tag: str) -> Callable[[Dict[str, Any]], PrimitiveEntry]:
    def build(obj: Dict[str, Any]) -> PrimitiveEntry:
        return PrimitiveEntry(
            type=tag,
            serialized_value=obj["serialized_value"],
            replicated=obj["replicated"],
            readable=obj.get("readable"),
        )

    return build


for _tag in PRIMITIVE_TYPE_NAMES:
    _FROM_YAML[_tag] = _primitive_from_yaml(_tag)


Manifest = Dict[str, Entry]


def entry_from_yaml_obj(obj: Dict[str, Any]) -> Entry:
    tag = obj["type"]
    try:
        builder = _FROM_YAML[tag]
    except KeyError:
        raise ValueError(f"Unknown manifest entry type: {tag!r}") from None
    return builder(obj)


def entry_to_yaml_obj(entry: Entry) -> Dict[str, Any]:
    """Shallow, type-aware encoding. ``dataclasses.asdict`` deep-copies
    recursively with per-field introspection — the dominant planning cost
    for 1e5-leaf manifests; entries are flat except Shard lists, handled
    explicitly. The returned dict aliases the entry's lists, which is fine
    for immediate json/yaml dumping (neither mutates its input)."""
    d = dict(entry.__dict__)
    # ``digest`` stays out of the YAML form when unset so non-digest
    # snapshots keep their exact metadata bytes (and 1e5-leaf manifests
    # don't carry dead null fields).
    if d.get("digest") is None:
        d.pop("digest", None)
    for key in ("shards", "chunks"):
        shards = d.get(key)
        if shards:
            d[key] = [
                {
                    "offsets": s.offsets,
                    "sizes": s.sizes,
                    "array": _array_yaml_obj(s.array),
                }
                for s in shards
            ]
    return d


def _array_yaml_obj(array: ArrayEntry) -> Dict[str, Any]:
    a = dict(array.__dict__)
    if a.get("digest") is None:
        a.pop("digest", None)
    return a


def _load_yaml(text: str) -> Dict[str, Any]:
    try:
        import yaml
    except ImportError:
        raise RuntimeError(
            "this snapshot's metadata is YAML, not JSON, and reading it needs "
            "PyYAML, which is not installed"
        ) from None
    loader = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
    return yaml.load(text, Loader=loader)


@dataclass
class SnapshotMetadata:
    version: str
    world_size: int
    manifest: Manifest
    # Non-reference extension: records how many processes *wrote* (the nccl
    # local-world analog is unneeded; restore elasticity only needs this).

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "world_size": self.world_size,
            "manifest": {k: entry_to_yaml_obj(v) for k, v in self.manifest.items()},
        }

    def to_json(self) -> str:
        """The committed form; stays loadable by YAML readers because JSON
        is a YAML subset."""
        return json.dumps(self.to_dict())

    @classmethod
    def from_yaml(cls, yaml_str: str) -> "SnapshotMetadata":
        # JSON is the fast path (snapshots are committed as JSON, which is
        # a YAML subset — reference manifest.py:19-22 invariant); anything
        # json can't parse goes through the YAML loader.
        try:
            d = json.loads(yaml_str)
        except json.JSONDecodeError:
            d = _load_yaml(yaml_str)
        return cls(
            version=d["version"],
            world_size=d["world_size"],
            manifest={
                path: entry_from_yaml_obj(obj) for path, obj in d["manifest"].items()
            },
        )


def is_replicated(entry: Entry) -> bool:
    return bool(getattr(entry, "replicated", False))


def is_container_entry(entry: Entry) -> bool:
    return isinstance(entry, (ListEntry, DictEntry, OrderedDictEntry))


def is_dict_entry(entry: Entry) -> bool:
    return isinstance(entry, (DictEntry, OrderedDictEntry))


def get_manifest_for_rank(metadata: SnapshotMetadata, rank: int) -> Manifest:
    """Derive the entries available to ``rank`` from a global manifest.

    Availability rules (reference manifest.py:333-371):

    - *per-rank* entries are visible only to the rank that saved them;
    - *replicated* entries are visible to every rank;
    - *ShardedArray* entries are merged across ranks (union of shards,
      sorted by offsets) and visible to every rank.

    When an entry is copied into a rank that lacks its ancestor containers,
    fresh container entries are created listing only the copied children
    (the reference mutates shared entries in place — manifest.py:397-419;
    we build new ones to keep the global manifest pristine).
    """
    per_rank: Dict[int, Manifest] = {i: {} for i in range(metadata.world_size)}
    for path, entry in metadata.manifest.items():
        rnk_str, _, logical_path = path.partition("/")
        per_rank.setdefault(int(rnk_str), {})[logical_path] = entry

    local: Manifest = dict(per_rank.get(rank, {}))

    for src_rank, src_manifest in sorted(per_rank.items()):
        if src_rank == rank:
            continue
        for logical_path, entry in src_manifest.items():
            if isinstance(entry, ShardedArrayEntry):
                if logical_path not in local or not isinstance(
                    local.get(logical_path), ShardedArrayEntry
                ):
                    _graft_entry(local, src_manifest, logical_path, entry)
                else:
                    merged = local[logical_path].shards + entry.shards
                    local[logical_path] = ShardedArrayEntry(
                        dtype=entry.dtype,
                        shape=entry.shape,
                        shards=sorted(merged, key=lambda s: s.offsets),
                    )
            elif is_replicated(entry) and logical_path not in local:
                _graft_entry(local, src_manifest, logical_path, entry)
    return local


def _original_key(container: Entry, segment: str) -> Union[str, int]:
    """Map an encoded path segment back to the container's original key
    object so int dict keys keep their type in grafted manifests."""
    decoded = _unquote(segment)
    if is_dict_entry(container):
        for k in container.keys:
            if str(k) == decoded:
                return k
    return decoded


def _graft_entry(
    dst: Manifest, src: Manifest, logical_path: str, entry: Entry
) -> None:
    """Copy ``entry`` into ``dst`` and ensure its ancestor containers exist,
    extending (copies of) dict-entry key lists as needed."""
    dst[logical_path] = entry
    child = logical_path
    while "/" in child:
        parent, _, segment = child.rpartition("/")
        src_parent = src.get(parent)
        if parent in dst:
            existing = dst[parent]
            if is_dict_entry(existing):
                key = _original_key(
                    src_parent if src_parent is not None else existing, segment
                )
                if key not in existing.keys:
                    extended = copy.copy(existing)
                    extended.keys = list(existing.keys) + [key]
                    dst[parent] = extended
            break
        if src_parent is None:
            break
        if is_dict_entry(src_parent):
            trimmed = copy.copy(src_parent)
            trimmed.keys = [_original_key(src_parent, segment)]
            dst[parent] = trimmed
        else:
            dst[parent] = copy.copy(src_parent)
        child = parent
