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
    by qualified name. Pass an explicit ``port`` when juggling other
    listeners (two sequential :func:`get_free_port` calls can return the
    same just-released port)."""
    if port is None:
        port = get_free_port()
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
    for rank, conn in enumerate(conns):
        if conn.poll(max(0.0, deadline - time.monotonic())):
            status, payload_out = conn.recv()
            if status == "ok":
                results[rank] = pickle.loads(payload_out)
            else:
                errors.append(payload_out)
        else:
            errors.append(f"rank {rank}: timed out after {timeout}s")
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
    ``pg`` (rank 0 picks a free port and shares it through ``pg``'s store),
    so that a worker can build a ``DeviceMesh`` and ``DTensor``s. The
    package itself moves nothing through this group; end it with
    ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist

    from .pg_wrapper import PGWrapper

    port = PGWrapper(pg).broadcast_object(get_free_port() if pg.rank == 0 else None)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=pg.rank, world_size=pg.world_size
    )


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
