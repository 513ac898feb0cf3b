"""CDN topic registry: the announce/head key schema on the store.

Counterpart of ``torchsnapshot_tpu/cdn/topic.py``, with the same keys and
the same JSON record, so that either package's subscriber reads the
other's announces. A topic is a tiny single-writer log on the
coordination store's plain KV primitives:

- ``__cdn/<topic>/announce/<seq>``: one immutable announce record per
  published step: the step number, a digest of its chunk set, and the
  full chunk-store chunk set (``digest key -> nbytes``) the step's
  manifest references.
- ``__cdn/<topic>/head``: the highest *fully published* sequence number,
  written strictly after the announce record (commit marker last): a
  publisher killed between the two writes leaves a record no subscriber
  ever observes, never a torn announce that one will.

Subscribers poll the head key with the world-scaled
:class:`~torchsnapshot_tpu_torch.dist_store._PollPacer` backoff. The codec
is JSON, not pickle: a serving fleet on another package version reads a
training job's announces, and a damaged record decodes to ``None``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional

from ..dist_store import Store

# Key namespace on the coordination store (beside __endpoint etc.).
TOPIC_PREFIX = "__cdn"
# Endpoint-registry service of the subscribers' chunk servers
# (dist_store.publish_endpoint / lookup_endpoints).
CDN_SERVICE = "cdn-fleet"


def head_key(topic: str) -> str:
    return f"{TOPIC_PREFIX}/{topic}/head"


def announce_key(topic: str, seq: int) -> str:
    return f"{TOPIC_PREFIX}/{topic}/announce/{int(seq)}"


def manifest_digest(step: int, chunks: Dict[str, int]) -> str:
    """Deterministic digest of one announced step's chunk set. The chunk
    keys embed each chunk's digest, so hashing the sorted key set (and the
    step) commits to the content; subscribers re-derive it to catch
    field-level damage that a well-formed JSON parse lets through."""
    h = hashlib.sha256()
    h.update(str(int(step)).encode())
    for key in sorted(chunks):
        h.update(b"\0")
        h.update(key.encode())
    return h.hexdigest()


@dataclasses.dataclass
class Announce:
    """One published step, as subscribers see it."""

    topic: str
    seq: int
    step: int
    digest: str
    # Chunk key -> nbytes: the step's full chunk set (subscribers diff it
    # against what they hold).
    chunks: Dict[str, int]
    # Publisher wall clock at publish: the staleness anchor.
    published_ts: float
    publisher: str = ""

    @property
    def bytes_in_step(self) -> int:
        return int(sum(self.chunks.values()))

    def encode(self) -> bytes:
        return json.dumps(dataclasses.asdict(self), sort_keys=True).encode("utf-8")

    @classmethod
    def decode(cls, raw: bytes) -> Optional["Announce"]:
        """None for any damage: a subscriber treats a corrupt record as
        not yet published and never crashes on it."""
        try:
            doc = json.loads(raw.decode("utf-8"))
            ann = cls(
                topic=str(doc["topic"]),
                seq=int(doc["seq"]),
                step=int(doc["step"]),
                digest=str(doc["digest"]),
                chunks={str(k): int(v) for k, v in doc["chunks"].items()},
                published_ts=float(doc["published_ts"]),
                publisher=str(doc.get("publisher", "")),
            )
        except (ValueError, KeyError, TypeError, AttributeError, UnicodeDecodeError):
            return None
        if ann.digest != manifest_digest(ann.step, ann.chunks):
            return None  # field-level damage: the digest disagrees
        return ann


def read_head(store: Store, topic: str) -> int:
    """The highest fully published sequence number (0: nothing published
    yet). An unreadable or garbage head reads as 0: a subscriber facing a
    flaky store idles, never crashes."""
    try:
        raw = store.try_get(head_key(topic))
    except Exception:  # noqa: BLE001 - the poll path never raises
        return 0
    if raw is None:
        return 0
    try:
        return int(raw.decode())
    except (ValueError, UnicodeDecodeError):
        return 0


def read_announce(store: Store, topic: str, seq: int) -> Optional[Announce]:
    try:
        raw = store.try_get(announce_key(topic, seq))
    except Exception:  # noqa: BLE001 - the poll path never raises
        return None
    if raw is None:
        return None
    return Announce.decode(raw)


def verify_chunk_bytes(key: str, data: bytes) -> bool:
    """Verify chunk bytes against the self-describing chunk key (size and
    whole-blob CRC: the judgment ``fsck --cas --deep`` applies to chunks
    on disk). Every byte a subscriber accepts, from a peer or from durable
    storage, passes through this."""
    from ..cas import parse_key
    from ..integrity import _alg_available, _crc_of

    parsed = parse_key(key)
    if parsed is None:
        return False
    alg, want_n, want_crc = parsed
    if len(data) != want_n:
        return False
    if not _alg_available(alg):
        return True  # the bytes cannot be judged here; the size is all there is
    return _crc_of(memoryview(data), alg, seed=0) == want_crc


def fleet_member_id(doc: Any) -> str:
    """A stable printable id for log fields."""
    return str(doc)
