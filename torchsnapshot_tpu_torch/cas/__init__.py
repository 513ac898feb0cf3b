"""Content-addressed chunk store.

Counterpart of ``torchsnapshot_tpu/cas/``, under the same names and in
the same on-disk format. Blobs keyed by the integrity layer's content
digest live once in a root-level ``chunks/`` directory; manifests
reference them through parent-relative locations, and the manager
refcounts them through a crash-safe journal. ``TORCHSNAPSHOT_TPU_CAS=1``
turns the layout on for new takes; either layout restores everywhere.
On a ``tiered://`` root the store lives on both tiers, and the mirror
ships only the chunks the durable tier does not hold, and the peer tier
(``tiered/peer.py``) pools chunks by key: a push references the chunks
its neighbour already holds (one RPC) and ships only the rest.
"""

from .plugin import (
    CASStoragePlugin,
    chunk_map_path,
    is_data_path,
    load_chunk_maps,
    maybe_rewrite_manifest,
    rewrite_manifest_locations,
)
from .store import (
    CAS_MAP_DIR,
    CHUNK_LOCATION_PREFIX,
    CHUNKS_DIRNAME,
    REFCOUNTS_BASENAME,
    CASStore,
    cas_eligible,
    chunk_location,
    chunk_refs,
    digest_key,
    is_chunk_key,
    is_chunk_location,
    key_of_location,
    local_chunks_dir,
    nbytes_of_key,
    parse_key,
    root_url_of_snapshot,
)

__all__ = [
    "CAS_MAP_DIR",
    "CHUNK_LOCATION_PREFIX",
    "CHUNKS_DIRNAME",
    "REFCOUNTS_BASENAME",
    "CASStore",
    "CASStoragePlugin",
    "cas_eligible",
    "chunk_location",
    "chunk_map_path",
    "chunk_refs",
    "digest_key",
    "is_chunk_key",
    "is_chunk_location",
    "is_data_path",
    "key_of_location",
    "load_chunk_maps",
    "local_chunks_dir",
    "maybe_rewrite_manifest",
    "nbytes_of_key",
    "parse_key",
    "rewrite_manifest_locations",
    "root_url_of_snapshot",
]
