"""Multi-process test harness, shipped as part of the package.

Counterpart of ``torchsnapshot_tpu/test_utils.py``. :func:`run_multiprocess`
fans out plain ``multiprocessing`` spawn workers that rendezvous on a
:class:`~torchsnapshot_tpu_torch.dist_store.TCPStore` hosted by rank 0, so
that N-rank semantics run on one machine with no cluster and no
``torch.distributed`` group: the coordination layer moves only metadata.
The workers import this package and never ``jax``; a worker that wants a
CUDA card picks it itself (``torch.cuda.set_device``).

Also here: :func:`faulty_fs_plugin` / :func:`patch_storage_plugin` to make
a rank's storage operations fail, :class:`ByteCountingStore` to meter a
rank's coordination traffic, and :func:`drive_preemption_loop`.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

from .dist_store import ProcessGroup, Store, TCPStore  # noqa: F401 - re-export


def get_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def faulty_fs_plugin(
    should_fail: Callable[[str], bool],
    ops: Sequence[str] = ("write",),
    exc_msg: str = "injected storage failure",
    delay_s: float = 0.0,
    mode: str = "fail",
    seed: int = 0,
):
    """An ``FSStoragePlugin`` subclass whose listed ``ops`` ("write",
    "read", "delete"; "write" and "read" cover their fused
    ``*_with_checksum`` variants, which the chaos wrapper declines so that
    every op goes through the injected path) misbehave when
    ``should_fail(path)`` is truthy.

    A thin shim over one fault plan (``chaos/plan.py``), as in the JAX
    package: each listed op becomes a predicate-triggered
    :class:`~torchsnapshot_tpu_torch.chaos.FaultSpec`. ``mode``:

    - ``"fail"`` (default): raise ``OSError(exc_msg)``, after ``delay_s``
      if set;
    - ``"corrupt"``: flip one byte of the written bytes or of the read
      buffer, keeping the size (only a digest catches it);
    - ``"torn"``: write the first half of the bytes, then raise;
    - ``"delay"``: sleep ``delay_s``, then proceed;
    - ``"drop"`` and ``"crash"``, as the engine defines them.

    ``should_fail`` may filter by path or close over a counter. Pair with
    :func:`patch_storage_plugin`. The class's ``chaos_engine`` attribute
    is the backing engine (its ``fired`` log pins a replay)."""
    from .chaos import ChaosEngine, FaultPlan, FaultSpec, chaotic_plugin_type
    from .storage_plugins.fs import FSStoragePlugin

    point_of = {"write": "storage-write", "read": "storage-read", "delete": "storage-delete"}
    unknown = set(ops) - set(point_of)
    if unknown:
        raise ValueError(f"unknown storage ops {sorted(unknown)}")
    plan = FaultPlan(
        seed=seed,
        faults=[
            FaultSpec(
                point=point_of[op],
                mode=mode,
                times=None,
                predicate=should_fail,
                exc_msg=exc_msg,
                delay_s=delay_s,
            )
            for op in ops
        ],
    )
    engine = ChaosEngine(plan)
    cls = chaotic_plugin_type(FSStoragePlugin, engine)
    cls.chaos_engine = engine
    return cls


def patch_storage_plugin(cls):
    """Route ``Snapshot``'s plugin resolution to ``cls`` for the scope of
    the returned context manager."""
    from unittest import mock

    return mock.patch(
        "torchsnapshot_tpu_torch.snapshot.url_to_storage_plugin",
        side_effect=lambda url: cls(root=url.split("://")[-1]),
    )


class ByteCountingStore(Store):
    """Delegating store wrapper that meters this rank's coordination
    payload: bytes sent (``set`` values) and received (``try_get``
    results)."""

    def __init__(self, inner: Store) -> None:
        self.inner = inner
        self.sent_bytes = 0
        self.received_bytes = 0

    def set(self, key: str, value: bytes) -> None:
        self.sent_bytes += len(value)
        self.inner.set(key, value)

    def try_get(self, key: str):
        out = self.inner.try_get(key)
        if out is not None:
            self.received_bytes += len(out)
        return out

    def add(self, key: str, amount: int) -> int:
        return self.inner.add(key, amount)

    def delete(self, key: str) -> None:
        self.inner.delete(key)


def _worker_main(
    conn,
    fn_module: str,
    fn_qualname: str,
    fn_file: Optional[str],
    rank: int,
    world_size: int,
    port: int,
    args: bytes,
) -> None:
    try:
        import importlib
        import sys

        if fn_file is not None:
            sys.path.insert(0, os.path.dirname(os.path.abspath(fn_file)))
        module = importlib.import_module(fn_module)
        fn = module
        for part in fn_qualname.split("."):
            fn = getattr(fn, part)
        fn = getattr(fn, "_ts_inner_fn", fn)

        if port is None and rank == 0:
            # The store binds a port of the kernel's choosing, and the
            # parent hands it to the other ranks.
            store = TCPStore("127.0.0.1", 0, is_server=True)
            conn.send(("port", store.port))
        else:
            if port is None:
                port = conn.recv()
                if port is None:
                    raise RuntimeError("rank 0 failed before its store was up")
            store = TCPStore("127.0.0.1", port, is_server=(rank == 0))
        pg = ProcessGroup(store=store, rank=rank, world_size=world_size)
        extra_args, extra_kwargs = pickle.loads(args)
        result = fn(pg, *extra_args, **extra_kwargs)
        conn.send(("ok", pickle.dumps(result)))
        # Rank 0 hosts the store server: no worker may exit until every
        # worker reported, or stragglers' store ops hit a dead socket. The
        # parent acks once all results are in.
        conn.recv()
    except BaseException as e:  # noqa: BLE001 - reported to the parent
        conn.send(("error", f"rank {rank}: {e!r}\n{traceback.format_exc()}"))
    finally:
        conn.close()


def run_multiprocess(
    fn: Callable[..., Any],
    nproc: int,
    args: Sequence[Any] = (),
    kwargs: Optional[Dict[str, Any]] = None,
    timeout: float = 180.0,
    port: Optional[int] = None,
) -> List[Any]:
    """Run ``fn(pg, *args, **kwargs)`` in ``nproc`` spawned processes with
    a shared TCP store; returns the per-rank results, raises on any rank's
    failure, and ends every worker within ``timeout`` seconds (plus 10
    for the join) whatever they do.

    ``fn`` must be a module-level callable: spawned workers re-import it
    by qualified name. Without ``port``, rank 0's store binds a free port
    itself before any other rank dials it, so that no other process can
    take the port between its choice and its bind."""
    ctx = mp.get_context("spawn")
    payload = pickle.dumps((tuple(args), kwargs or {}))
    import importlib

    fn_file = getattr(importlib.import_module(fn.__module__), "__file__", None)
    procs = []
    conns = []
    for rank in range(nproc):
        parent_conn, child_conn = ctx.Pipe()
        p = ctx.Process(
            target=_worker_main,
            args=(child_conn, fn.__module__, fn.__qualname__, fn_file, rank, nproc, port, payload),
            daemon=True,
        )
        p.start()
        procs.append(p)
        conns.append(parent_conn)

    deadline = time.monotonic() + timeout
    results: List[Any] = [None] * nproc
    errors: List[str] = []
    first: Optional[Any] = None  # rank 0's report, if it came before its port
    if port is None:
        if conns[0].poll(timeout):
            first = conns[0].recv()
        else:
            first = ("error", f"rank 0: timed out after {timeout}s")
        bound = first[1] if first[0] == "port" else None
        if bound is not None:
            first = None
        for conn in conns[1:]:
            try:
                conn.send(bound)
            except (BrokenPipeError, OSError):
                pass
    for rank, conn in enumerate(conns):
        if rank == 0 and first is not None:
            status, payload_out = first
        elif conn.poll(max(0.0, deadline - time.monotonic())):
            status, payload_out = conn.recv()
        else:
            errors.append(f"rank {rank}: timed out after {timeout}s")
            continue
        if status == "ok":
            results[rank] = pickle.loads(payload_out)
        else:
            errors.append(payload_out)
    # Release the workers only after every rank reported (the rank-0
    # worker hosts the store server for the others).
    for conn in conns:
        try:
            conn.send("exit")
        except (BrokenPipeError, OSError):
            pass
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.terminate()
            p.join(timeout=5)
    if errors:
        raise AssertionError("Multiprocess run failed:\n" + "\n".join(errors))
    return results


def init_torch_group(pg: ProcessGroup, backend: str = "gloo") -> None:
    """Start ``torch.distributed``'s default group over the same ranks as
    ``pg`` (rank 0 binds the group's store on a free port and shares the
    port through ``pg``'s store), so that a worker can build a
    ``DeviceMesh`` and ``DTensor``s. The package itself moves nothing
    through this group; end it with
    ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist

    from .pg_wrapper import PGWrapper

    host, n, leader = "127.0.0.1", pg.world_size, pg.rank == 0
    store = dist.TCPStore(host, 0, n, True, wait_for_workers=False) if leader else None
    port = PGWrapper(pg).broadcast_object(store.port if leader else None)
    if store is None:
        store = dist.TCPStore(host, port, n, False)
    dist.init_process_group(backend, store=store, rank=pg.rank, world_size=n)


def multiprocess_test(nproc: int):
    """Decorator: ``@multiprocess_test(nproc=2)`` turns
    ``def test_x(pg): ...`` into a fan-out test."""

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        # No functools.wraps: pytest would follow __wrapped__ and treat the
        # inner function's ``pg`` parameter as a fixture. Workers re-import
        # the inner function through the _ts_inner_fn attribute.
        def wrapper() -> None:
            run_multiprocess(wrapper, nproc=nproc)

        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__module__ = fn.__module__
        wrapper.__doc__ = fn.__doc__
        wrapper._ts_inner_fn = fn
        return wrapper

    return deco


def drive_preemption_loop(
    pg,
    saver,
    save_fn: Callable[[int], None],
    evict_rank: int,
    evict_step: int = 2,
    steps: int = 200,
    pace_s: float = 0.02,
) -> Optional[int]:
    """Run a paced step loop, inject an eviction notice on one rank, save
    through ``save_fn(step)`` at the agreed step; returns it (None if no
    agreement fired). The pacing stands for real steps' wall time: without
    it an unflagged rank exhausts its loop before the flag lands."""
    saved_at: Optional[int] = None
    for step in range(steps):
        time.sleep(pace_s)
        if pg.rank == evict_rank and step == evict_step:
            saver.request_save()
        if saver.should_save(step):
            save_fn(step)
            saved_at = step
            break
    saver.close()
    return saved_at


def write_sharded_reference_snapshot(
    path: str, app_state: Dict[str, Any], world_size: int = 4, slab_max_bytes: int = 1 << 20
) -> Dict[str, int]:
    """Write ``app_state`` as a ``world_size``-rank snapshot in the format
    of the reference TorchSnapshot 0.0.3 (its manifest schema, written from
    the schema alone, as the reference's ranks would leave it), at the
    local directory ``path``:

    - a tensor of two or more dimensions becomes a ``ShardedTensor``: rank
      r's entry holds one shard, the r-th dim-0 chunk (``torch.chunk``'s
      ceil split, so trailing ranks may hold none), in its own blob;
    - other tensors of at most ``slab_max_bytes`` share batched slabs
      (``batched/slab_<n>``, each entry a ``byte_range`` of its slab), and
      larger ones have a blob each; both are replicated ``Tensor`` entries
      that rank 0 records (the post-partitioning form);
    - primitives are inline entries and other leaves ``torch_save``
      objects, replicated, recorded by rank 0;
    - every rank records the containers.

    Tensors may be on the card. Returns the counts of sharded entries,
    shards, slabs, slab members and whole-blob tensors."""
    import io as _io

    import torch

    from .flatten import flatten
    from .parallel.overlap import placements_box
    from .serialization import tensor_as_memoryview
    from .tricks.torchsnapshot_writer import (
        _BUFFER_PROTOCOL_DTYPES,
        _container_to_reference,
        _prepare_leaf,
        metadata_text,
    )

    def _write(location: str, data) -> None:
        full = os.path.join(path, location)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "wb") as f:
            f.write(data)

    def _tensor(location: str, t, byte_range=None, replicated=True) -> Dict[str, Any]:
        return {
            "type": "Tensor", "location": location, "serializer": "buffer_protocol",
            "dtype": _BUFFER_PROTOCOL_DTYPES[t.dtype], "shape": list(t.shape),
            "replicated": replicated, "byte_range": byte_range,
        }

    counts = dict.fromkeys(("sharded", "shards", "slabs", "slab_members", "whole"), 0)
    manifest: Dict[str, Any] = {}
    slab = _io.BytesIO()
    slab_entries: List[str] = []

    def _flush_slab() -> None:
        if slab_entries:
            _write(f"batched/slab_{counts['slabs']}", slab.getvalue())
            counts["slabs"] += 1
            slab.seek(0)
            slab.truncate()
            slab_entries.clear()

    for key, value in app_state.items():
        containers, leaves = flatten(value, prefix=key)
        for rank in range(world_size):
            for cpath, centry in containers.items():
                manifest[f"{rank}/{cpath}"] = _container_to_reference(centry)
        for lpath, leaf in leaves.items():
            if not isinstance(leaf, torch.Tensor):
                entry, blob = _prepare_leaf(lpath, leaf)
                entry["replicated"] = True
                if blob is not None:
                    entry["location"] = f"replicated/{lpath}"
                    _write(entry["location"], blob)
                manifest[f"0/{lpath}"] = entry
                continue
            t = leaf.detach().contiguous().cpu()
            if t.ndim >= 2:
                counts["sharded"] += 1
                for rank in range(world_size):
                    box = placements_box(tuple(t.shape), (world_size,), (rank,), (("shard", 0),))
                    if not box.sizes[0]:
                        continue
                    piece = t[box.offsets[0] : box.offsets[0] + box.sizes[0]].contiguous()
                    location = f"sharded/{lpath}_{box.offsets[0]}"
                    _write(location, tensor_as_memoryview(piece))
                    manifest[f"{rank}/{lpath}"] = {"type": "ShardedTensor", "shards": [{
                        "offsets": list(box.offsets), "sizes": list(box.sizes),
                        "tensor": _tensor(location, piece, replicated=False),
                    }]}
                    counts["shards"] += 1
                continue
            data = tensor_as_memoryview(t)
            if data.nbytes <= slab_max_bytes:
                if slab.tell() + data.nbytes > slab_max_bytes:
                    _flush_slab()
                start = slab.tell()
                slab.write(data)
                location = f"batched/slab_{counts['slabs']}"
                manifest[f"0/{lpath}"] = _tensor(location, t, byte_range=[start, start + data.nbytes])
                slab_entries.append(lpath)
                counts["slab_members"] += 1
            else:
                location = f"replicated/{lpath}"
                _write(location, data)
                manifest[f"0/{lpath}"] = _tensor(location, t)
                counts["whole"] += 1
    _flush_slab()
    doc = {"version": "0.0.3", "world_size": world_size, "manifest": manifest}
    with open(os.path.join(path, ".snapshot_metadata"), "w", encoding="utf-8") as f:
        f.write(metadata_text(doc))
    return counts
