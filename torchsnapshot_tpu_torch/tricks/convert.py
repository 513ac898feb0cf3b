"""Convert a reference-format (TorchSnapshot 0.0.3) snapshot to the native
format, as a one-shot CLI::

    python -m torchsnapshot_tpu_torch.tricks.convert OLD_SNAPSHOT NEW_SNAPSHOT \\
        [--rank N] [--verify] [--device cpu]

Counterpart of ``torchsnapshot_tpu/tricks/convert.py``. Reads the old
checkpoint with :mod:`.torchsnapshot_reader` (the rank-N view: replicated
entries, merged shards) onto the card, or the CPU with ``--device cpu``,
and re-saves it with ``Snapshot.take(record_digests=True)``, whose digests
the card computes: the full native feature set then applies to it
(incremental chaining, integrity digests, fsck, manager retention), and
its digests are the ones the JAX package's ``convert`` records for the
same source. ``--verify`` walks the source manifest first and fails fast
on missing or truncated blobs, so a half-copied checkpoint is caught
before the converted snapshot exists (the destination appears only on
success).

Tensor leaves convert losslessly (bf16 included); other leaves
(primitives, pickled objects) ride the native object path.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List

from ..snapshot import Snapshot
from ..state_dict import TensorTreeState
from ..utils.device import Device
from .torchsnapshot_reader import ReferenceSnapshotReader, torch_dtype


def verify_source(reader: ReferenceSnapshotReader, rank: int) -> List[str]:
    """Shallow integrity walk of the source (the native fsck's
    existence/length pass, applied to the reference format): every blob a
    leaf entry points at must exist and cover the entry's byte need.
    Probes with a one-byte ranged read of the last required byte: no blob
    is materialized. Returns problem descriptions (empty = clean)."""
    problems: List[str] = []
    # (location, need) -> verdict, so shared slabs probe once per need.
    checked: Dict[tuple, str] = {}

    def _probe(location: str, need: int) -> str:
        key = (location, need)
        if key not in checked:
            try:
                # Reading [need-1, need) succeeds iff the blob exists and
                # holds at least ``need`` bytes (the FS plugin fails short
                # ranged reads; need 0 degenerates to an existence check).
                reader._read_blob(location, (max(need - 1, 0), max(need, 0)))
                checked[key] = ""
            except FileNotFoundError:
                checked[key] = f"missing blob {location}"
            except OSError:
                # The truncation contract shared by every plugin: a short
                # ranged read raises OSError(EIO).
                checked[key] = f"blob {location} is shorter than the {need} bytes its entry needs"
            except Exception as e:  # noqa: BLE001 - verification must
                # report, not crash: an unnormalized backend error still
                # belongs in the problem list the caller was promised.
                checked[key] = f"blob {location} unreadable: {e!r}"
        return checked[key]

    for logical, entry in reader.manifest_for_rank(rank).items():
        kind = entry.get("type")
        tensors = []
        if kind in ("Tensor", "object"):
            tensors = [entry]
        elif kind == "ShardedTensor":
            tensors = [s["tensor"] for s in entry["shards"]]
        elif kind == "ChunkedTensor":
            tensors = [c["tensor"] for c in entry["chunks"]]
        for t in tensors:
            br = t.get("byte_range")
            if br:
                need = int(br[1])
            elif t.get("serializer") == "buffer_protocol":
                # Raw little-endian layout: exact size is dtype x shape.
                need = torch_dtype(t["dtype"]).itemsize
                for dim in t.get("shape", []):
                    need *= int(dim)
            else:
                need = 1  # torch_save streams: exact size unknowable here
            verdict = _probe(t["location"], need)
            if verdict:
                problems.append(f"{logical}: {verdict}")
    return problems


def dropped_rank_entries(reader: ReferenceSnapshotReader, rank: int) -> Dict[int, List[str]]:
    """Other ranks' PER-RANK entries that a rank-``rank`` conversion
    cannot carry: non-replicated, non-sharded leaves owned by another rank
    (availability rules make replicated and sharded state complete from
    any rank; per-rank state is private)."""
    dropped: Dict[int, List[str]] = {}
    for path, entry in reader.metadata["manifest"].items():
        rnk_str, _, logical = path.partition("/")
        rnk = int(rnk_str)
        kind = entry.get("type")
        if (
            rnk != rank
            and kind not in ("list", "dict", "OrderedDict", "ShardedTensor")
            and not entry.get("replicated")
        ):
            dropped.setdefault(rnk, []).append(logical)
    return dropped


def convert(
    src: str, dst: str, rank: int = 0, verify: bool = False, device: Device = None
) -> Dict[str, float]:
    """Convert ``src`` (reference format) to a native snapshot at ``dst``,
    the state read onto ``device`` (the card by default). Returns the
    seconds of the read and of the take."""
    t0 = time.monotonic()
    reader = ReferenceSnapshotReader(src, device=device)
    try:
        dropped = dropped_rank_entries(reader, rank)
        if dropped:
            detail = "; ".join(
                f"rank {r}: {len(paths)} entries (e.g. {paths[0]!r})"
                for r, paths in sorted(dropped.items())
            )
            print(
                f"convert: WARNING — per-rank state of other ranks is NOT "
                f"carried by a --rank {rank} conversion: {detail}. Convert "
                f"each rank separately before retiring the source.",
                file=sys.stderr,
            )
        if verify:
            problems = verify_source(reader, rank)
            if problems:
                raise RuntimeError(
                    "source snapshot failed verification:\n  " + "\n  ".join(problems)
                )
        state = reader.read_state(rank=rank)
    finally:
        reader.close()
    for key, value in state.items():
        if not isinstance(value, dict):
            raise TypeError(
                f"app state key {key!r} holds a {type(value).__name__}, not a dict: "
                f"the native snapshot takes a dict tree per key"
            )
    read_s = time.monotonic() - t0
    t0 = time.monotonic()
    # record_digests: the converted snapshot must be a valid
    # incremental_base for the user's next take.
    Snapshot.take(dst, {key: TensorTreeState(value) for key, value in state.items()}, record_digests=True)
    return {"read_s": read_s, "take_s": time.monotonic() - t0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert a TorchSnapshot-format snapshot to the native format."
    )
    parser.add_argument("src", help="reference-format snapshot (a local path or URL)")
    parser.add_argument("dst", help="destination for the native snapshot")
    parser.add_argument(
        "--rank",
        type=int,
        default=0,
        help="which rank's view to convert (default 0; replicated and "
        "sharded state is complete from any rank)",
    )
    parser.add_argument(
        "--verify",
        action="store_true",
        help="walk the source manifest first; fail on missing/truncated "
        "blobs before writing anything",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="where the state is read to before the take (default: the CUDA card)",
    )
    args = parser.parse_args(argv)
    try:
        convert(args.src, args.dst, rank=args.rank, verify=args.verify, device=args.device)
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"convert: {e}", file=sys.stderr)
        return 1
    print(f"converted {args.src} (rank {args.rank}) -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
