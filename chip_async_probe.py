#!/usr/bin/env python3
"""What an async take's background drain costs the training step beside it.

Run from the root of a checkout on a machine with one CUDA card:
``python3 chip_async_probe.py``. It builds the train state of
``chip_smoke.py``'s main phase (d_model 1024, 8 layers, bf16, 1.007 GB with
the AdamW moments) and warms it up, then times one training step while each
kind of background work runs on another thread, started just before the
step:

- ``none``: nothing (the step alone);
- ``snapshot``: ``Snapshot.async_take`` of the state (also its visible,
  staged and committed seconds, and a sync take's seconds after it);
- ``snapshot_host``: the same of a copy of the state in host memory (the
  drain then makes no CUDA call);
- ``d2h``: the copies of every tensor of the state into pinned host buffers
  allocated up front, one at a time on a side stream, each waited on;
- ``d2h_alloc``: the same with each pinned buffer allocated just before its
  copy, as the staging path does;
- ``d2h_clones``: on-device clones of the tensors made first (as an async
  take's capture), then each clone copied to a new pinned buffer, its
  memory handed to the copy stream (``record_stream``) and dropped after
  its copy, as the staging path does;
- ``writes``: 1 GB of host bytes written to files in 64 MiB pieces through
  the native fused write + CRC, on four threads;
- ``handoffs``: no I/O at all, only the drain's shape of thread handoffs:
  an event loop runs 171 tasks (one per leaf of the state), each making 30
  round trips to a four-thread executor with an empty function;

in the order above (or ``--variants``) and then reversed, ``--reps`` times
each. For the step it
reports the host's seconds to issue it (the call's return) and the seconds
to its stream's end. Last, one step beside the async take's drain runs
under ``torch.profiler`` (CPU activity): each thread's busiest host
operations and their share of the window. It prints one line per
measurement and, second to last, a JSON record with each variant's
medians; the last line names the card and its power limit. Without a card
it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
VARIANTS = (
    "none", "snapshot", "snapshot_host", "d2h", "d2h_alloc", "d2h_clones", "writes", "handoffs"
)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--variants", default=",".join(VARIANTS))
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_async_probe: no CUDA card; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, _native
    from torchsnapshot_tpu_torch.models.transformer import (
        init_train_state,
        make_train_step,
        random_tokens,
    )

    card = chip_smoke.card_line()
    print(f"{card}; {len(os.sched_getaffinity(0))} CPUs for this process", flush=True)
    cfg = chip_smoke.main_config()
    state = init_train_state(cfg, seed=args.seed)
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, args.seed)).cuda()
    train_step = make_train_step(cfg)
    for _ in range(3):
        train_step(state, tokens)
    torch.cuda.synchronize()
    tensors = [t for t in chip_smoke._state_tensors(state).values() if t.is_cuda]
    host_state = {str(i): t.cpu() for i, t in enumerate(tensors)}
    pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    host_bytes = torch.ones(64 << 20, dtype=torch.uint8)
    copy_stream = torch.cuda.Stream()
    if _native.lib() is None:
        raise RuntimeError("the native I/O runtime did not build")

    work = tempfile.mkdtemp(prefix="ts_async_probe_")

    def d2h(alloc: bool) -> None:
        copy_stream.wait_stream(torch.cuda.current_stream())
        for t, h in zip(tensors, pinned):
            if alloc:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            with torch.cuda.stream(copy_stream):
                h.copy_(t, non_blocking=True)
                ev = torch.cuda.Event(blocking=True)
                ev.record(copy_stream)
            ev.synchronize()

    def d2h_clones(clones: list) -> None:
        copy_stream.wait_stream(torch.cuda.current_stream())
        while clones:
            t = clones.pop(0)
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            t.record_stream(copy_stream)
            with torch.cuda.stream(copy_stream):
                h.copy_(t, non_blocking=True)
                ev = torch.cuda.Event(blocking=True)
                ev.record(copy_stream)
            del t
            ev.synchronize()

    def handoffs() -> None:
        loop = asyncio.new_event_loop()
        pool = ThreadPoolExecutor(4)

        async def one() -> None:
            for _ in range(30):
                await loop.run_in_executor(pool, lambda: None)

        async def all_leaves() -> None:
            await asyncio.gather(*(one() for _ in range(len(tensors))))

        try:
            loop.run_until_complete(all_leaves())
        finally:
            pool.shutdown()
            loop.close()

    def writes(tag: str) -> None:
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(
                lambda i: _native.write_file_crc(
                    os.path.join(work, f"{tag}_{i}"), host_bytes.numpy(), 4 << 20
                ),
                range(16),
            ))

    variants = tuple(args.variants.split(","))
    rows = {v: [] for v in variants}
    try:
        Snapshot.take(os.path.join(work, "warm"), {"train": state})
        Snapshot.async_take(os.path.join(work, "warm_async"), {"train": state}).wait()
        for variant in variants + tuple(reversed(variants)):
            for _ in range(args.reps):
                tag = f"{variant}_{len(rows[variant])}"
                torch.cuda.synchronize()
                row = {}
                pending = None
                thread = None
                t0 = time.monotonic()
                if variant.startswith("snapshot"):
                    source = {"train": state} if variant == "snapshot" else {
                        "host": TensorTreeState(host_state)
                    }
                    pending = Snapshot.async_take(os.path.join(work, tag), source)
                    row["async_visible_s"] = time.monotonic() - t0
                elif variant != "none":
                    clones = [t.clone() for t in tensors] if variant == "d2h_clones" else None
                    target = {
                        "d2h": lambda: d2h(False), "d2h_alloc": lambda: d2h(True),
                        "d2h_clones": lambda c=clones: d2h_clones(c), "writes": lambda: writes(tag),
                        "handoffs": handoffs,
                    }[variant]
                    clones = None  # the thread holds the only references
                    thread = threading.Thread(target=target)
                    thread.start()
                s0 = time.monotonic()
                train_step(state, tokens)
                row["step_issue_s"] = time.monotonic() - s0
                torch.cuda.current_stream().synchronize()
                row["step_s"] = time.monotonic() - s0
                if pending is not None:
                    pending.wait()
                    row["async_staged_s"] = pending.staged_s
                    row["async_committed_s"] = pending.committed_s
                if thread is not None:
                    thread.join()
                row["background_s"] = time.monotonic() - t0
                if variant == "snapshot":
                    torch.cuda.synchronize()
                    t1 = time.monotonic()
                    Snapshot.take(os.path.join(work, tag + "_sync"), {"train": state})
                    row["sync_take_s"] = time.monotonic() - t1
                rows[variant].append(row)
                print(f"{tag}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
                for name in os.listdir(work):
                    if name.startswith(tag):
                        path = os.path.join(work, name)
                        if os.path.isdir(path):
                            shutil.rmtree(path, ignore_errors=True)
                        else:
                            os.remove(path)
        profile_beside_drain(state, tokens, train_step, os.path.join(work, "profiled"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    medians = {v: {k: statistics.median(r[k] for r in rs) for k in rs[0]} for v, rs in rows.items()}
    print(json.dumps({"async_probe": {"card": card, "median": medians}}))
    print(card)
    return 0


def profile_beside_drain(state, tokens, train_step, path: str) -> None:
    """One training step beside an async take's drain under torch.profiler:
    per thread, the host operations with the most self time, and the sum of
    their self time against the profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchsnapshot_tpu_torch import Snapshot

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.monotonic()
        pending = Snapshot.async_take(path, {"train": state})
        train_step(state, tokens)
        torch.cuda.current_stream().synchronize()
        step_end = time.monotonic() - t0
        pending.wait()
        window = time.monotonic() - t0
    by_thread = {}
    for e in prof.events():
        ops = by_thread.setdefault(e.thread, {})
        us, n = ops.get(e.name, (0.0, 0))
        ops[e.name] = (us + e.self_cpu_time_total, n + 1)
    print(f"profile: step ended {step_end:.4f} s after the call, drain {window:.4f} s", flush=True)
    for tid, ops in sorted(by_thread.items(), key=lambda kv: -sum(u for u, _ in kv[1].values())):
        total = sum(u for u, _ in ops.values()) / 1e6
        top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:8]
        print(
            f"profile thread {tid}: {sum(n for _, n in ops.values())} ops, self time {total:.4f} s "
            f"({total / window:.3f} of the window); top: "
            + "; ".join(f"{name} {us / 1e3:.2f} ms in {n}" for name, (us, n) in top),
            flush=True,
        )


if __name__ == "__main__":
    sys.exit(main())
