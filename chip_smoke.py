#!/usr/bin/env python3
"""Smoke run of torchsnapshot_tpu_torch on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card; without one it exits non-zero and prints no result. Phases,
each of which raises on failure (nothing is caught):

1. **kernels**: build every CUDA kernel under
   ``torchsnapshot_tpu_torch/csrc`` and hold each against its plain PyTorch
   version on the card. Flash: at the training shape and a long-sequence
   shape, in bf16 and f32, and at the tensor-core kernels' edges (a half
   tile, a chunk with s_k = 2 s_q, the fused-qkv layout; bf16 and f32 at
   d = 64 and 128; f32's split pre-pass is held bit for bit against its
   plain version). Digest: bit for
   bit against the plain version and the host digest, over every dtype the
   port serializes, odd lengths, row ranges, an unaligned tail, an empty
   tensor and a non-contiguous view; then on the train state's own chunk
   table (one launch) and on the bulk state's. Time kernel, plain version
   and the library call (none for the digest) back to back (the record's
   ms), and each kernel again behind a spin kernel: the card's time alone
   and the host's cost per wrapper call. The digest's card time is also
   split by the profiler into its main kernel and the rest (memset, table
   copy, finalize), logged with the SM clock and power while it ran, the
   host's time to build the kernel's table, and the design's reckoned
   integer instructions per lane.
   The host I/O runtime (``native/ts_io.cpp``) is built here too, so the
   timed takes and restores below hold no compile.
2. **main**: the port's main path. Train the widest in-repo transformer
   (d_model 1024, 8 layers, flash attention, bf16) for a few AdamW steps,
   ``Snapshot.take`` the train state, ``Snapshot.restore`` it into a fresh
   model and optimizer built from another seed, and check that every
   tensor, the step and the RNG state came back bit for bit, that the
   evaluation logits of both agree bit for bit, and that one more training
   step gives the same loss on both. The last training step runs under
   ``torch.profiler``: the device operations that took the most time, the
   flash kernels' share of the step and the device's idle share. Then
   (a) ``async_take(record_digests=True)`` with a training step run while
   it drains, restored bit-identical to the state at the call; (b) with
   the embedding and the first half of the layers frozen, an incremental
   take against a digest-recording base: the bytes copied to the host and
   written equal the bytes of the leaves that changed, and the restore is
   bit-identical and continues with the same loss; (c) ``async_restore``
   with a forward pass before ``wait()``: the live leaves are untouched
   until then and bit-identical after. The kernels' launch counters are set
   to 0 just before the phase and read just after: the path must have
   launched every kernel.
3. **bulk**: take and restore a bulk bf16 state of (16384, 8192) blocks
   (8 GiB by default, ``--bulk-gib 20`` for the reference's 20 GB figure)
   with a bitwise check; then a digest-recording take and an incremental
   take of the unchanged state, which writes no data blob.

The second-to-last line of stdout is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_TF32_FLOPS = 494.7e12

# The slice's configuration: the widest transformer the repo runs
# (benchmarks/pod/main.py), all 8 layers, trained for 3 steps.
N_LAYERS = 8
STEPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, from CUDA
    events around them: the card's time, or the host's where the host issues
    the calls more slowly than the card runs them. The ``ms`` the kernels'
    record reports."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ~5 ms of spin on the card: longer than the host takes to queue a timed
# run of flash wrapper calls.
HOLD_CYCLES = 10_000_000
# ~50 ms: the digest wrapper's host cost was up to 2.4 ms a call, so ten
# calls outlasted the 5 ms spin and the card's time took in the host's gaps.
DIGEST_HOLD_CYCLES = 100_000_000


def held_times(fn, iters: int = 10, warmup: int = 2, hold_cycles: int = HOLD_CYCLES) -> tuple:
    """``(device ms, host us)`` per call of ``fn``. A spin kernel holds the
    stream while the calls queue up behind it, so the events time the card's
    work alone and the host's clock times what each call costs the host
    (argument checks, allocations, the launch itself). The spin must outlast
    the host's ``iters`` calls, or the card's time includes the host's."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(hold_cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s / iters * 1e6


# ----------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ----------------------------------------------------------------------


def _qkv(shape, dtype, seed: int, fused_qkv: bool, s_k=None):
    """q, k, v on the card from a seed. With ``fused_qkv`` they are the
    strided slices of one (b, s, 3, h, d) tensor, as the model makes them;
    ``s_k`` gives k and v another length than q."""
    import torch

    b, s, h, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused_qkv:
        qkv = torch.randn((b, s, 3, h, d), generator=g, device="cuda").to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    kv_shape = (b, s if s_k is None else s_k, h, d)
    return tuple(
        torch.randn(sh, generator=g, device="cuda").to(dtype)
        for sh in (shape, kv_shape, kv_shape)
    )


def kernel_phase(seed: int) -> dict:
    """Hold both kernels against their plain versions and time them; returns
    the per-kernel record at the main path's shape (bf16, (8, 1024, 16, 64))."""
    import torch
    import torch.nn.functional as F

    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    # (q shape (b, s, h, d), s_k, dtype, fused-qkv layout, timed)
    cases = [
        ((8, 1024, 16, 64), 1024, torch.bfloat16, True, True),  # the main path's call
        ((8, 1024, 16, 64), 1024, torch.float32, False, True),
        ((2, 4096, 16, 128), 4096, torch.bfloat16, False, True),
        ((2, 4096, 16, 128), 4096, torch.float32, False, True),
        # The tensor-core kernels' edges, checked only: the fused-qkv layout
        # (bf16 d = 128, f32 d = 64 and 128), a sequence of 64 but not 128 (a
        # half tile), and a chunk whose keys outnumber its queries.
        ((2, 1024, 16, 128), 1024, torch.bfloat16, True, False),
        ((2, 192, 4, 64), 192, torch.bfloat16, False, False),
        ((2, 128, 4, 64), 256, torch.bfloat16, False, False),
        ((2, 1024, 16, 64), 1024, torch.float32, True, False),
        ((2, 192, 4, 64), 192, torch.float32, False, False),
        ((2, 128, 4, 64), 256, torch.float32, False, False),
        ((2, 1024, 16, 128), 1024, torch.float32, True, False),
        ((2, 192, 4, 128), 192, torch.float32, False, False),
        ((2, 128, 4, 128), 256, torch.float32, False, False),
    ]
    records = {}
    for shape, s_k, dtype, fused_qkv, timed in cases:
        b, s, h, d = shape
        dt = str(dtype).split(".")[1]
        q, k, v = _qkv(shape, dtype, seed, fused_qkv, s_k)
        block = 128 if s % 128 == 0 and s_k % 128 == 0 else 64
        label = f"{tuple(shape)} s_k={s_k} {dt}{' fused-qkv' if fused_qkv else ''}"
        split = dtype == torch.float32
        if split:
            _require(
                all(same_bits(a, b) for a, b in zip(fa.flash_split(q, k, v), fa.flash_split_plain(q, k, v))),
                f"the split pre-pass differs from its plain version at {label}",
            )
        errs = fa.compare_with_plain(q, k, v, block)
        tols = (
            f"(fused rtol {fa.FUSED_TOL[dtype][0]} atol {fa.FUSED_TOL[dtype][1]}; chunk o/l "
            f"atol {errs['chunk_atol']:.3e}, m and l {fa.F32_TOL})"
        )
        if not timed:
            log(
                f"kernel check {label}: max |err| "
                + ", ".join(f"{n} {e:.3e}" for n, e in errs.items() if n != "chunk_atol")
                + f" {tols}"
            )
            continue
        itemsize = q.element_size()
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

        def fwd():
            return fa.flash_causal_forward(q, k, v)

        def chunk():
            return fa.flash_attention_chunk(q, k, v, causal=True)

        library_ms = cuda_ms(sdpa)
        sdpa_device_ms, _ = held_times(sdpa)
        flops = fa.attention_flops(b, h, s, s, d, causal=True)
        op_ms = flops / PEAK_FLOPS[dt] * 1e3
        nbytes = 4 * b * s * h * d * itemsize
        nbytes_c = 3 * b * s * h * d * itemsize + 4 * b * h * s * (d + 2)
        recs = {}
        bounds = ""
        entry_bytes = {"flash_fwd": nbytes, "flash_chunk": nbytes_c}
        if split:
            # The f32 entries' bound is the function's own bytes (q, k, v
            # in, the outputs out) against three tf32 products for each f32
            # one. Logged beside it: the f32-FMA bound, and the bytes the
            # design moves (the pre-pass reads q, k, v and writes hi and lo
            # of each, 9 tensors; the main kernel reads those 6 and writes
            # its outputs).
            split_bytes = 9 * b * s * h * d * 4
            design_bytes = {
                name: split_bytes + 3 * b * s * h * d * 4 + n for name, n in entry_bytes.items()
            }
            fma_ms, op_ms = op_ms, 3 * flops / PEAK_TF32_FLOPS * 1e3
            bounds = (
                f"; f32-FMA bound {fma_ms:.4f} ms, 3xTF32 operation bound {op_ms:.4f} ms, "
                f"the function's own bytes {entry_bytes['flash_chunk'] / HBM_BYTES_PER_S * 1e3:.4f} ms "
                f"(chunk), {entry_bytes['flash_fwd'] / HBM_BYTES_PER_S * 1e3:.4f} ms (fused), "
                f"bytes of pre-pass + main kernel "
                f"{design_bytes['flash_chunk'] / HBM_BYTES_PER_S * 1e3:.4f} ms (chunk), "
                f"{design_bytes['flash_fwd'] / HBM_BYTES_PER_S * 1e3:.4f} ms (fused)"
            )

            def split_fn():
                return fa.flash_split(q, k, v)

            rec = recs["flash_split"] = {
                "ms": cuda_ms(split_fn),
                "plain_ms": cuda_ms(lambda: fa.flash_split_plain(q, k, v), iters=3),
                "library_ms": None,
                "bound_ms": split_bytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "max_abs_err": 0.0,  # bit for bit, checked above
            }
            device_ms, host_us = held_times(split_fn)
            log(
                f"kernel flash_split {label}: {rec['ms']:.4f} ms back to back, "
                f"{split_bytes / rec['ms'] / 1e9:.1f} TB/s; device {device_ms:.4f} ms, host "
                f"{host_us:.1f} us per call (plain {rec['plain_ms']:.4f} ms; no library call; "
                f"bound {rec['bound_ms']:.4f} ms by bytes); bit-identical to the plain version"
            )
        for name, fn, plain, err in (
            ("flash_fwd", fwd, lambda: fa.flash_causal_forward_plain(q, k, v), errs["flash_fwd"]),
            ("flash_chunk", chunk, lambda: fa.flash_attention_chunk_plain(q, k, v, causal=True),
             errs["flash_chunk_causal"]),
        ):
            bytes_ms = entry_bytes[name] / HBM_BYTES_PER_S * 1e3
            rec = recs[name] = {
                "ms": cuda_ms(fn),
                "plain_ms": cuda_ms(plain, iters=3),
                "library_ms": library_ms,
                "bound_ms": max(bytes_ms, op_ms),
                "bound_by": "bytes" if bytes_ms > op_ms else "operations",
                "max_abs_err": err,
            }
            device_ms, host_us = held_times(fn)
            log(
                f"kernel {name} {label}: {rec['ms']:.4f} ms back to back, "
                f"{flops / rec['ms'] / 1e9:.1f} TFLOP/s; device {device_ms:.4f} ms, host "
                f"{host_us:.1f} us per call (plain {rec['plain_ms']:.4f} ms, SDPA "
                f"{rec['library_ms']:.4f} ms, device {sdpa_device_ms:.4f} ms; bound "
                f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}), max |err| "
                f"{rec['max_abs_err']:.3e} {tols}{bounds}"
            )
        if (shape, dtype) == ((8, 1024, 16, 64), torch.bfloat16):
            records.update(recs)
        elif "flash_split" in recs:  # the record keeps the first, at d = 64
            records.setdefault("flash_split", recs["flash_split"])
        del qh, kh, vh
    del q, k, v
    torch.cuda.empty_cache()

    # Gradients through the autograd Function against the dense op, f32,
    # small: the backward is plain torch, the forward the chunk kernel.
    q, k, v = (t.detach().requires_grad_() for t in _qkv((2, 256, 4, 64), torch.float32, seed, False))
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa.flash_causal_attention(q, k, v).square().sum().backward()
    from torchsnapshot_tpu_torch.ops import causal_attention

    causal_attention(q2, k2, v2).square().sum().backward()
    for a, bb in ((q, q2), (k, k2), (v, v2)):
        torch.testing.assert_close(a.grad, bb.grad, rtol=1e-4, atol=1e-4)
    log("kernel flash_chunk: autograd gradients match the dense op (tol 1e-4)")
    return records


def _digest_case_specs(seed: int) -> list:
    """(label, specs) of the digest kernel's checks: every dtype the port
    serializes and the digest takes; odd row counts and row bytes, row
    ranges at unaligned starts, a tail shorter than one 16-byte load, an
    empty tensor, a non-contiguous view."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dtypes = [
        torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int64,
        torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool,
        torch.float8_e4m3fn,
    ]
    cases = []
    for dtype in dtypes:
        def make(*shape, dtype=dtype):
            if dtype == torch.bool:
                return torch.rand(shape, generator=g, device="cuda") > 0.5
            if dtype.is_floating_point:
                return (100 * torch.randn(shape, generator=g, device="cuda")).to(dtype)
            return torch.randint(-100, 100, shape, generator=g, device="cuda").to(dtype)

        big = make(1031, 77)
        cases.append((str(dtype).split(".")[1], [
            (big, None),
            (big, ((0, 1), (3, 517), (517, 1031), (9, 9))),
            (make(3, 5), None),
            (make(0), None),
            (make(64, 33)[:, 1::2], None),
            (make(200_003), ((7, 199_999),)),
        ]))
    return cases


def _train_state_digest_specs(seed: int):
    """The train state and its chunk table as an incremental take digests
    it (one launch)."""
    import torch

    from torchsnapshot_tpu_torch.flatten import flatten
    from torchsnapshot_tpu_torch.incremental import IncrementalTakeContext
    from torchsnapshot_tpu_torch.models.transformer import init_train_state

    state = init_train_state(main_config(), seed=seed)  # AdamW moments included
    _, flat = flatten(state.state_dict(), prefix="train")
    batches = IncrementalTakeContext(None, None, None, 0).collect(flat)
    return state, batches[torch.device("cuda", torch.cuda.current_device())].specs


def digest_phase(seed: int, bulk_gib: float) -> dict:
    """Hold the digest kernel against its plain version and the host digest
    bit for bit, then time it on the train state's chunk table and the bulk
    state's; returns the record at the train state (the main path's call)."""
    import torch

    from torchsnapshot_tpu_torch.ops import device_digest as dd

    cases = _digest_case_specs(seed)
    for label, specs in cases:
        kernel = dd.materialize_many(dd.digest_many_async(specs))
        plain = dd.materialize_many(dd.digest_many_plain(specs))
        host = []
        for t, ranges in specs:
            t = t.cpu()
            host += [dd.digest_host(t)] if ranges is None else [dd.digest_host(t[a:b]) for a, b in ranges]
        _require((kernel == plain).all(), f"digest {label} differs from the plain version")
        _require(
            [(int(d1), int(d2)) for d1, d2 in kernel] == host, f"digest {label} differs from the host digest"
        )
    del cases
    log("kernel device_digest: 11 dtypes x 6 layouts (odd lengths, row ranges, an unaligned "
        "tail, an empty tensor, a non-contiguous view) bit-identical to the plain version and "
        "the host digest")

    state, specs = _train_state_digest_specs(seed)
    record = _time_digest("train state", specs)
    del state, specs
    torch.cuda.empty_cache()
    bulk = bulk_state(seed, bulk_gib)
    from torchsnapshot_tpu_torch.flatten import flatten
    from torchsnapshot_tpu_torch.incremental import IncrementalTakeContext

    _, flat = flatten(bulk, prefix="bulk")
    batches = IncrementalTakeContext(None, None, None, 0).collect(flat)
    _time_digest("bulk state", batches[torch.device("cuda", torch.cuda.current_device())].specs)
    del bulk, flat, batches
    torch.cuda.empty_cache()
    return record


def _time_digest(label: str, specs) -> dict:
    from torchsnapshot_tpu_torch.ops import device_digest as dd

    nbytes = dd.digest_bytes(specs)
    kernel = dd.materialize_many(dd.digest_many_async(specs))
    plain = dd.materialize_many(dd.digest_many_plain(specs))
    mismatched = int((kernel != plain).any(axis=1).sum())
    _require(mismatched == 0, f"digest of the {label} differs from the plain version in {mismatched} rows")
    # The host digest too, on 8 rows spread over the table (the whole state
    # would take the host minutes).
    pieces = []
    for t, ranges in specs:
        pieces += [t] if ranges is None else [t[a:b] for a, b in ranges]
    picked = sorted({round(i * (len(pieces) - 1) / 7) for i in range(8)})
    host = [dd.digest_host(pieces[i].cpu()) for i in picked]
    _require([tuple(int(x) for x in kernel[i]) for i in picked] == host,
             f"digest of the {label} differs from the host digest")

    def fn():
        return dd.digest_many_async(specs)

    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    t = digest_timings(fn)
    rec = {
        "ms": t["ms"],
        "plain_ms": cuda_ms(lambda: dd.digest_many_plain(specs), iters=1, warmup=0),
        "library_ms": None,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "max_abs_err": float(abs(kernel.astype("int64") - plain.astype("int64")).max()),
    }
    table = dd.build_table(specs)
    table_us = []
    for _ in range(50):
        t0 = time.perf_counter()
        dd.build_table(specs)
        table_us.append((time.perf_counter() - t0) * 1e6)
    log(
        f"kernel device_digest {label}: {len(kernel)} rows, {nbytes / 1e9:.3f} GB in one launch "
        f"({table.n_items} items): {rec['ms']:.4f} ms back to back, "
        f"{nbytes / rec['ms'] / 1e6:.1f} GB/s; device {t['device_ms']:.4f} ms "
        f"({nbytes / t['device_ms'] / 1e6:.1f} GB/s, {bound_ms / t['device_ms']:.1%} of the bound), "
        f"of which the main kernel {t['main_ms']:.4f} ms and the rest (memset, table copy, "
        f"finalize) {t['rest_ms']:.4f} ms by the profiler; host {t['host_us']:.1f} us per call, "
        f"of which the table {statistics.median(table_us):.1f} us (median of 50) (plain {rec['plain_ms']:.2f} ms; no library call computes it; bound {bound_ms:.4f} ms by "
        f"bytes at 3.35 TB/s; the design's reckoned integer instructions per lane "
        f"{reckoned_int_ops_per_lane(table):.2f}); SM clock / power while timed: {t['clocks']}; "
        f"bit-identical to the plain version, and on {len(picked)} rows to the host digest"
    )
    return rec


def digest_timings(fn) -> dict:
    """The digest wrapper ``fn`` timed as every tree's digest is: ms back to
    back, card ms and host us per call behind a spin kernel, the card's time
    split by the profiler into the main kernel and the rest, and the SM
    clock and power sampled while it runs."""
    device_ms, host_us = held_times(fn, hold_cycles=DIGEST_HOLD_CYCLES)
    ops = device_ops_ms(fn)
    main_ms = sum(ms for name, ms in ops.items() if "digest" in name and "finalize" not in name)
    return {
        "ms": cuda_ms(fn, iters=10), "device_ms": device_ms, "host_us": host_us,
        "main_ms": main_ms, "rest_ms": sum(ops.values()) - main_ms, "ops": ops,
        "clocks": clocks_during(fn),
    }


def device_ops_ms(fn, iters: int = 10) -> dict:
    """Device time per call of ``fn`` by operation name (kernels, copies,
    memsets), from torch.profiler over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3 / iters
            ops[e.name] = ops.get(e.name, 0.0) + ms
    return ops


def clocks_during(fn, seconds: float = 0.5) -> str:
    """The SM clock and power draw that nvidia-smi reads every 50 ms while
    ``fn`` runs back to back for ``seconds``: 'clock min-max MHz, power
    max W (limit)'."""
    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True,
    )
    try:
        time.sleep(0.2)  # its first reading
        t0 = time.monotonic()
        while time.monotonic() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines()[1:] if line.count(",") == 2]
    if not rows:
        return "not read"
    clocks = [r[0] for r in rows]
    return (f"clock {min(clocks):.0f}-{max(clocks):.0f} MHz, power max "
            f"{max(r[1] for r in rows):.1f} W (limit {rows[0][2]:.0f} W)")


# The digest design's integer instructions (csrc/device_digest.cu), as
# reckoned from its code: per lane, its extraction (none for 4-byte lanes)
# and two multiply-adds; per weight pair, 19 (the index step, two seed adds,
# two mix32s of 8), one pair per lane of every (item, sub-window) reached;
# per (segment, sub-window), 3 a thread (two warp sums and the slot's add).
DIGEST_SUB_LANES = 4096  # lanes of a sub-window: 256 threads x 16


def reckoned_int_ops_per_lane(table) -> float:
    import numpy as np

    from torchsnapshot_tpu_torch.ops import device_digest as dd

    seg, win = table.segments, table.windows
    lane = seg["lane_bytes"].astype(np.int64)
    nb = seg["nbytes"]
    sub_bytes = DIGEST_SUB_LANES * lane
    lanes = nb // lane
    if not lanes.sum():
        return 0.0
    data = (lanes * np.where(lane == 4, 2, 3)).sum()
    reduce = 3 * 256 * (-(-nb // sub_bytes)).sum()
    n = win["n_reach"].astype(np.int64)
    k = dd.items_per_window(n)
    w = np.repeat(np.arange(len(win)), k)
    i = np.arange(k.sum()) - np.repeat(np.cumsum(k) - k, k)
    first = win["seg_begin"][w] + i * n[w] // k[w]  # each item's longest segment
    reach = np.minimum(nb[first] - win["index"][w].astype(np.int64) * dd.WINDOW_BYTES, dd.WINDOW_BYTES)
    weights = 19 * DIGEST_SUB_LANES * (-(-reach // sub_bytes[first])).sum()
    return float((data + reduce + weights) / lanes.sum())


# ----------------------------------------------------------------------
# Entry
# ----------------------------------------------------------------------


KERNEL_SOURCES = {
    "flash_fwd": (
        "torchsnapshot_tpu_torch/csrc/flash_attention.cu",
        "torchsnapshot_tpu/ops/flash_attention.py:395",
    ),
    "flash_chunk": (
        "torchsnapshot_tpu_torch/csrc/flash_attention.cu",
        "torchsnapshot_tpu/ops/flash_attention.py:223",
    ),
    "device_digest": (
        "torchsnapshot_tpu_torch/csrc/device_digest.cu",
        "torchsnapshot_tpu/ops/device_digest.py:237",
    ),
    # The f32 entries' pre-pass: a part of both flash kernels'
    # f32 port (the fused entry's pallas_call named here, the chunk's at :223).
    "flash_split": (
        "torchsnapshot_tpu_torch/csrc/flash_attention.cu",
        "torchsnapshot_tpu/ops/flash_attention.py:395",
    ),
}
# The kernels the main path must launch (it trains in bf16: no f32 entry,
# so no split pre-pass).
MAIN_PATH_KERNELS = ("flash_fwd", "flash_chunk", "device_digest")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phases", default="kernels,main,bulk")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bulk-gib", type=float, default=8.0)
    args = p.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "torchsnapshot_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.ops import kernels

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    built = kernels.build()
    log(f"kernel build: {time.monotonic() - t0:.1f} s wall, per source {built}")
    for name, text in kernels.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma", "setmaxnreg")):
                log(f"ptxas {name}: {line.strip()}")
    # The host I/O runtime (pwritev, CRC32-C) also compiles at first use;
    # build it here so that the timed take and restore hold no compile.
    from torchsnapshot_tpu_torch import _native

    t0 = time.monotonic()
    _require(_native.lib() is not None, "the native I/O runtime did not build")
    log(f"native I/O runtime: {time.monotonic() - t0:.1f} s to build and load")

    records = {}
    if "kernels" in phases:
        t0 = time.monotonic()
        records = kernel_phase(args.seed)
        records["device_digest"] = digest_phase(args.seed, args.bulk_gib)
        log(f"phase kernels: {time.monotonic() - t0:.1f} s")

    # Launches are counted only in the main path's run; without it they
    # were not measured and the record says null.
    launches = dict.fromkeys(list(fa.launch_counts) + list(dd.launch_counts))
    work_dir = tempfile.mkdtemp(prefix="ts_chip_smoke_")
    try:
        if "main" in phases:
            t0 = time.monotonic()
            launches = main_phase(args, work_dir, card)
            log(f"phase main: {time.monotonic() - t0:.1f} s")
        if "bulk" in phases:
            t0 = time.monotonic()
            bulk_phase(args, work_dir, card)
            log(f"phase bulk: {time.monotonic() - t0:.1f} s")
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    if records:
        kernels_line = []
        for name, (source, replaces) in KERNEL_SOURCES.items():
            kernels_line.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], **records[name],
            })
        print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def same_bits(a, b) -> bool:
    """Bitwise equality of two tensors (``torch.equal`` calls -0 == 0 and
    NaN != NaN; the bytes are what a restore must reproduce)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a = a.detach().contiguous().reshape(-1).view(torch.uint8)
    b = b.detach().contiguous().reshape(-1).view(torch.uint8)
    return torch.equal(a, b.to(a.device))


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main_config():
    """The widest transformer the repo runs (benchmarks/pod/main.py)."""
    import torch

    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=32768, d_model=1024, n_heads=16, n_layers=N_LAYERS,
        d_ff=4096, dtype=torch.bfloat16, attn_impl="flash",
    )


def main_phase(args, work_dir: str, card: str) -> dict:
    """Train, take, restore into a fresh state, and check the restored
    run continues bit for bit; then the async and incremental legs.
    Returns the kernels' launch counts of the run."""
    import torch

    from torchsnapshot_tpu_torch import RngState, Snapshot
    from torchsnapshot_tpu_torch.models.transformer import (
        init_train_state,
        make_train_step,
        random_tokens,
    )
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.scheduler import last_phase_timings, reset_phase_timings

    cfg = main_config()
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, args.seed)).cuda()
    torch.manual_seed(args.seed)  # the global generators RngState holds
    state = init_train_state(cfg, seed=args.seed)
    train_step = make_train_step(cfg)

    fa.reset_launch_counts()
    dd.reset_launch_counts()
    t0 = time.monotonic()
    losses = []
    for _ in range(STEPS):
        state, loss = train_step(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.monotonic() - t0) / STEPS
    losses = [float(x) for x in losses]
    _require(all(x == x and abs(x) < 1e4 for x in losses), f"losses not finite: {losses}")
    _require(
        fa.launch_counts["flash_chunk"] == cfg.n_layers * STEPS,
        f"training launched the chunk kernel {fa.launch_counts['flash_chunk']} times",
    )
    n_params = sum(p.numel() for p in state.model.parameters())
    state_bytes = sum(
        t.numel() * t.element_size()
        for t in list(state.model.parameters())
        + [v for s in state.optimizer.state.values() for v in s.values()]
    )
    log(
        f"main: {n_params / 1e6:.1f} M params, train state {state_bytes / 1e9:.3f} GB; "
        f"{STEPS} steps, {step_s * 1e3:.1f} ms/step (first step included), "
        f"losses {losses}"
    )

    torch.rand(3)
    torch.rand(3, device="cuda")  # nontrivial global RNG states
    rng_at_take = (torch.get_rng_state(), torch.cuda.get_rng_state())
    path = os.path.join(work_dir, "main")
    torch.cuda.synchronize()
    reset_phase_timings()
    t0 = time.monotonic()
    Snapshot.take(path, {"train": state, "rng": RngState()})
    take_s = time.monotonic() - t0
    # Seconds from the write pipeline's start to the end of each phase.
    take_phases = last_phase_timings()
    # A training job takes again and again: the second take finds the
    # pinned host buffers of the first in torch's caching host allocator.
    t0 = time.monotonic()
    Snapshot.take(path + "_again", {"train": state})
    take_again_s = time.monotonic() - t0
    shutil.rmtree(path + "_again", ignore_errors=True)

    fresh = init_train_state(cfg, seed=args.seed + 1)
    torch.rand(5)
    torch.rand(5, device="cuda")
    _require(not same_bits(fresh.model.embed, state.model.embed), "fresh model equals the trained one")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(path).restore({"train": fresh, "rng": RngState()})
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0

    for (name, a), (_, b) in zip(state.model.named_parameters(), fresh.model.named_parameters()):
        _require(same_bits(a, b), f"parameter {name} differs after restore")
    sa, sb = state.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    _require(sorted(sa) == sorted(sb), "optimizer state keys differ")
    for i in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            _require(same_bits(sa[i][key], sb[i][key]), f"optimizer state {i}/{key} differs")
            _require(sb[i][key].device == sa[i][key].device, f"optimizer {i}/{key} moved device")
    _require(fresh.step == state.step, "step differs")
    _require(same_bits(fresh.rng.get_state(), state.rng.get_state()), "train RNG differs")
    _require(
        same_bits(torch.get_rng_state(), rng_at_take[0])
        and same_bits(torch.cuda.get_rng_state(), rng_at_take[1]),
        "global RNG state differs",
    )

    fwd_before = fa.launch_counts["flash_fwd"]
    with torch.no_grad():
        logits_a = state.model(tokens)
        logits_b = fresh.model(tokens)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(logits_a).all()), "evaluation logits not finite")
    _require(logits_a.shape == (8, 1024, cfg.vocab_size), "evaluation logits shape")
    _require(same_bits(logits_a, logits_b), "evaluation logits differ after restore")
    _require(
        fa.launch_counts["flash_fwd"] - fwd_before == 2 * cfg.n_layers,
        "the evaluation forward did not launch the fused kernel once per layer",
    )
    del logits_a, logits_b

    _, loss_a = train_step(state, tokens)
    (_, loss_b), profile = profile_step(lambda: train_step(fresh, tokens))
    torch.cuda.synchronize()
    _require(same_bits(loss_a, loss_b), f"next-step losses differ: {loss_a} vs {loss_b}")
    for (name, a), (_, b) in zip(state.model.named_parameters(), fresh.model.named_parameters()):
        _require(same_bits(a, b), f"parameter {name} differs after the next step")
    snap_bytes = sum(
        os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs
    )
    del fresh
    torch.cuda.empty_cache()
    shutil.rmtree(path, ignore_errors=True)

    async_record = async_and_incremental(args, work_dir, card, cfg, state, tokens, train_step, take_s)
    launches = {**fa.launch_counts, **dd.launch_counts}
    _require(
        all(launches[name] for name in MAIN_PATH_KERNELS),
        f"a kernel of the path never launched: {launches}",
    )
    record = {
        "card": card, "params": n_params, "train_state_bytes": state_bytes,
        "snapshot_bytes": snap_bytes, "take_s": take_s, "restore_s": restore_s,
        "take_gb_s": state_bytes / take_s / 1e9, "restore_gb_s": state_bytes / restore_s / 1e9,
        "take_again_s": take_again_s, "take_again_gb_s": state_bytes / take_again_s / 1e9,
        "take_phases_s": take_phases, "step_ms": step_s * 1e3, "losses": losses,
        "next_loss": float(loss_a), "launches": launches, "profile": profile,
        **async_record,
    }
    log(
        f"main: take {take_s:.3f} s ({record['take_gb_s']:.2f} GB/s; again "
        f"{take_again_s:.3f} s, {record['take_again_gb_s']:.2f} GB/s), restore "
        f"{restore_s:.3f} s ({record['restore_gb_s']:.2f} GB/s) of {state_bytes / 1e9:.3f} GB "
        f"on {card}; restored state, logits and next-step loss {float(loss_a)!r} bit-identical; "
        f"launches {launches}"
    )
    print(json.dumps({"main": record}), flush=True)
    del state
    torch.cuda.empty_cache()
    return launches


def _state_tensors(state) -> dict:
    """Every tensor of a train state by name: parameters, AdamW moments and
    step counters, and the training RNG's state."""
    out = {f"param/{n}": p for n, p in state.model.named_parameters()}
    for i, s in state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            out[f"opt/{i}/{k}"] = v
    out["rng"] = state.rng.get_state()
    return out


def _require_same_state(a: dict, b, what: str) -> None:
    """``a`` (a dict of tensors) against train state ``b``, bit for bit."""
    tb = _state_tensors(b)
    _require(sorted(a) == sorted(tb), f"{what}: the states hold other tensors")
    for k in a:
        _require(same_bits(a[k], tb[k]), f"{what}: {k} differs")


def _changed_bytes(before: dict, after: dict) -> int:
    """Bytes of the CUDA leaves' chunks (as a digest-enabled take cuts
    them) whose bits differ between two captures of a train state."""
    from torchsnapshot_tpu_torch.io_preparer import (
        ChunkedArrayIOPreparer,
        chunk_shapes,
        effective_max_chunk_size_bytes,
    )

    total = 0
    for k, a in before.items():
        if not a.is_cuda:
            continue
        b = after[k]
        if ChunkedArrayIOPreparer.should_chunk(a, incremental=True):
            pieces = [
                (a[s:e], b[s:e])
                for s, e in chunk_shapes(list(a.shape), a.element_size(), effective_max_chunk_size_bytes(True))
            ]
        else:
            pieces = [(a, b)]
        total += sum(x.numel() * x.element_size() for x, y in pieces if not same_bits(x, y))
    return total


def _written_data_bytes(path: str) -> int:
    """Bytes of the data blobs under a snapshot (commit marker and checksum
    tables excluded)."""
    total = 0
    for d, _, files in os.walk(path):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), path)
            if not rel.startswith((".snapshot_metadata", "checksums")):
                total += os.path.getsize(os.path.join(d, f))
    return total


def _counter(name: str) -> float:
    from torchsnapshot_tpu_torch import telemetry

    return sum(
        v for k, v in telemetry.metrics().counters_snapshot().items() if k.split("{")[0] == name
    )


def async_and_incremental(args, work_dir, card, cfg, state, tokens, train_step, sync_take_s) -> dict:
    """Main phase legs (a) async take, (b) incremental take, (c) async
    restore, on the trained state."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot
    from torchsnapshot_tpu_torch.models.transformer import init_train_state
    from torchsnapshot_tpu_torch.telemetry import names

    # (a) async_take with digests; a training step mutates every parameter
    # and moment in place while the snapshot drains. A step alone first, as
    # the yardstick of the one that overlaps the drain.
    torch.cuda.synchronize()
    t0 = time.monotonic()
    train_step(state, tokens)
    torch.cuda.current_stream().synchronize()
    step_alone_s = time.monotonic() - t0
    at_call = {k: v.clone() for k, v in _state_tensors(state).items()}
    path_a = os.path.join(work_dir, "async")
    t0 = time.monotonic()
    pending = Snapshot.async_take(path_a, {"train": state}, record_digests=True)
    visible_s = time.monotonic() - t0
    train_step(state, tokens)
    # The training stream's end; a device-wide synchronize would also wait
    # for the drain's copies.
    torch.cuda.current_stream().synchronize()
    step_during_drain_s = time.monotonic() - t0 - visible_s
    pending.wait(phase="staged")
    pending.wait()
    fresh = init_train_state(cfg, seed=args.seed + 2)
    Snapshot(path_a).restore({"train": fresh})
    torch.cuda.synchronize()
    _require_same_state(at_call, fresh, "async take")
    del at_call, fresh
    shutil.rmtree(path_a, ignore_errors=True)
    log(
        f"main (a): async_take visible {pending.visible_s:.4f} s (call {visible_s:.4f} s), "
        f"staged {pending.staged_s:.3f} s, committed {pending.committed_s:.3f} s after the call "
        f"(sync take {sync_take_s:.3f} s); a training step of {step_during_drain_s:.3f} s ran while "
        f"it drained (alone {step_alone_s:.3f} s); restored state bit-identical to the state at the call, on {card}"
    )

    # (b) Freeze the embedding and the first half of the layers (AdamW then
    # leaves their moments and step counters alone), take a digest base,
    # run a step, take incrementally: only what changed is copied and written.
    frozen = [state.model.embed] + [
        p for blk in state.model.layers[: cfg.n_layers // 2] for p in blk.parameters()
    ]
    for p in frozen:
        p.requires_grad_(False)
    path_b0, path_b1 = os.path.join(work_dir, "base"), os.path.join(work_dir, "incr")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot.take(path_b0, {"train": state}, record_digests=True)
    base_take_s = time.monotonic() - t0
    before_step = {k: v.clone() for k, v in _state_tensors(state).items()}
    train_step(state, tokens)
    trainable_bytes = sum(3 * p.numel() * p.element_size() for p in state.model.parameters() if p.requires_grad)
    changed_bytes = _changed_bytes(before_step, _state_tensors(state))
    del before_step
    d2h0, written0 = _counter(names.DEVICE_TO_HOST_BYTES_TOTAL), _counter(names.STORAGE_WRITE_BYTES_TOTAL)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot.take(path_b1, {"train": state}, incremental_base=path_b0)
    incr_take_s = time.monotonic() - t0
    d2h = _counter(names.DEVICE_TO_HOST_BYTES_TOTAL) - d2h0
    written_all = _counter(names.STORAGE_WRITE_BYTES_TOTAL) - written0
    written = _written_data_bytes(path_b1)
    _require(d2h == changed_bytes, f"incremental take copied {d2h} bytes to the host, {changed_bytes} changed")
    # Beyond the changed leaves only small CPU leaves (step counters, the
    # RNG state, pickled param groups) are written.
    _require(
        changed_bytes <= written <= changed_bytes + (1 << 20),
        f"incremental take wrote {written} data bytes, {changed_bytes} changed",
    )
    fresh_b = init_train_state(cfg, seed=args.seed + 3)
    Snapshot(path_b1).restore({"train": fresh_b})
    torch.cuda.synchronize()
    now = {k: v.clone() for k, v in _state_tensors(state).items()}
    _require_same_state(now, fresh_b, "incremental take")
    log(
        f"main (b): {len(frozen)} of {len(list(state.model.parameters()))} parameters frozen; "
        f"base take {base_take_s:.3f} s, incremental take {incr_take_s:.3f} s: {d2h / 1e6:.3f} MB "
        f"copied to the host and {written / 1e6:.3f} MB of data written ({written_all / 1e6:.3f} MB "
        f"with checksum table and commit marker) for {changed_bytes / 1e6:.3f} MB of chunks that "
        f"changed (trainable parameters and their moments {trainable_bytes / 1e6:.3f} MB; state {sum(v.numel() * v.element_size() for v in now.values()) / 1e9:.3f} GB); "
        f"restore bit-identical, on {card}"
    )

    # (c) async_restore into a fresh state; a forward pass runs before wait().
    fresh_c = init_train_state(cfg, seed=args.seed + 4)
    before = {k: v.clone() for k, v in _state_tensors(fresh_c).items()}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    pending_r = Snapshot(path_b1).async_restore({"train": fresh_c})
    restore_visible_s = time.monotonic() - t0
    with torch.no_grad():
        logits = fresh_c.model(tokens)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(logits).all()), "forward pass during async_restore not finite")
    while not pending_r.done():
        time.sleep(0.005)
    reads_s = time.monotonic() - t0
    _require_same_state(before, fresh_c, "live leaves before wait()")
    pending_r.wait()
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    _require_same_state(now, fresh_c, "async restore")
    log(
        f"main (c): async_restore visible {restore_visible_s:.4f} s, reads and placement done "
        f"{reads_s:.3f} s, applied {restore_s:.3f} s; live leaves untouched until wait() and "
        f"bit-identical after, on {card}"
    )

    _, loss_a = train_step(state, tokens)
    for p in fresh_b.model.parameters():
        p.requires_grad_(True)
    for p in [fresh_b.model.embed] + [
        p for blk in fresh_b.model.layers[: cfg.n_layers // 2] for p in blk.parameters()
    ]:
        p.requires_grad_(False)
    _, loss_b = train_step(fresh_b, tokens)
    torch.cuda.synchronize()
    _require(same_bits(loss_a, loss_b), f"next-step losses differ after the incremental restore: {loss_a} vs {loss_b}")
    for path in (path_b0, path_b1):
        shutil.rmtree(path, ignore_errors=True)
    return {
        "async_visible_s": pending.visible_s, "async_staged_s": pending.staged_s,
        "async_committed_s": pending.committed_s, "step_alone_s": step_alone_s,
        "step_during_drain_s": step_during_drain_s,
        "incremental_base_take_s": base_take_s, "incremental_take_s": incr_take_s,
        "incremental_changed_bytes": changed_bytes, "incremental_trainable_bytes": trainable_bytes,
        "incremental_d2h_bytes": d2h,
        "incremental_written_bytes": written, "async_restore_visible_s": restore_visible_s,
        "async_restore_reads_s": reads_s, "async_restore_s": restore_s,
    }


def profile_step(run):
    """Run ``run()`` once under torch.profiler (CPU and CUDA activities) and
    break the card's time down: the ten device operations that took the
    most time, the flash kernels' share, and the card's idle share of the
    profiled window (the host's span of the step, through its final
    synchronize). Returns ``run()``'s result and the breakdown, or None
    when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    events = list(prof.events())
    # Work on the card: kernels, copies, sets; not the annotations that
    # span them (e.g. Optimizer.step), which would count their kernels twice.
    dev = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and "annotation" not in str(getattr(e, "activity_type", "") or "")
    ]
    if not dev:
        log("profile: torch.profiler recorded no device time on this card; "
            "the step's breakdown is not measured")
        return out, None
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    busy, covered_to = 0.0, float("-inf")  # length of the union of device spans
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy += max(0.0, b - max(a, covered_to))
        covered_to = max(covered_to, b)
    by_name = {}
    for e in dev:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.end - e.time_range.start, n + 1)
    device_us = sum(us for us, _ in by_name.values())
    flash_us = sum(us for name, (us, _) in by_name.items() if "flash_" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    record = {
        "window_ms": (t1 - t0) / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1 - busy / (t1 - t0),
        "device_op_ms": device_us / 1e3,
        "flash_ms": flash_us / 1e3,
        "flash_share_of_device_time": flash_us / device_us,
        "top10": [{"name": n[:160], "ms": us / 1e3, "calls": c} for n, (us, c) in top],
    }
    log(
        f"profile of one training step: window {record['window_ms']:.3f} ms, device busy "
        f"{record['device_busy_ms']:.3f} ms (idle share {record['device_idle_share']:.4f}); "
        f"flash kernels {record['flash_ms']:.3f} ms = "
        f"{record['flash_share_of_device_time']:.4f} of device op time"
    )
    for i, row in enumerate(record["top10"], 1):
        log(f"profile top{i}: {row['ms']:.3f} ms in {row['calls']} calls: {row['name']}")
    return out, record


BULK_BLOCK = (16384, 8192)
BULK_BLOCK_BYTES = BULK_BLOCK[0] * BULK_BLOCK[1] * 2


def bulk_state(seed: int, gib: float) -> dict:
    """bf16 blocks of (16384, 8192), ``gib`` GiB of them, plus a 64 Ki f32
    bias, shaped like bench.py's make_state, on the card from a seed."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    state = {
        f"w{i}": torch.randn(BULK_BLOCK, generator=g, device="cuda", dtype=torch.bfloat16)
        for i in range(max(1, int(gib * 2**30) // BULK_BLOCK_BYTES))
    }
    state["bias"] = torch.ones(65536, device="cuda")
    return state


def bulk_phase(args, work_dir: str, card: str) -> None:
    """Take and restore bf16 (16384, 8192) blocks shaped like bench.py's
    make_state, with a bitwise check."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
    from torchsnapshot_tpu_torch.scheduler import last_phase_timings, reset_phase_timings

    state = bulk_state(args.seed, args.bulk_gib)
    n_blocks = len(state) - 1
    free = shutil.disk_usage(work_dir).free
    _require(
        free > BULK_BLOCK_BYTES * n_blocks * 1.1,
        f"{work_dir} has {free / 2**30:.1f} GiB free; the bulk phase needs "
        f"{n_blocks * BULK_BLOCK_BYTES / 2**30:.1f} GiB",
    )
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    path = os.path.join(work_dir, "bulk")
    torch.cuda.synchronize()
    reset_phase_timings()
    t0 = time.monotonic()
    Snapshot.take(path, {"bulk": TensorTreeState(state)})
    take_s = time.monotonic() - t0
    phases = last_phase_timings()

    target = {k: torch.zeros_like(v) for k, v in state.items()}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(path).restore({"bulk": TensorTreeState(target)})
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    phases.update(last_phase_timings())
    for k in state:
        _require(same_bits(state[k], target[k]), f"bulk block {k} differs after restore")
    del target
    shutil.rmtree(path, ignore_errors=True)

    # A digest-recording take, then an incremental take of the unchanged
    # state: every chunk is a ref, no data blob is written.
    path_d, path_i = os.path.join(work_dir, "bulk_digests"), os.path.join(work_dir, "bulk_incr")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot.take(path_d, {"bulk": TensorTreeState(state)}, record_digests=True)
    digest_take_s = time.monotonic() - t0
    t0 = time.monotonic()
    Snapshot.take(path_i, {"bulk": TensorTreeState(state)}, incremental_base=path_d)
    incr_take_s = time.monotonic() - t0
    _require(_written_data_bytes(path_i) == 0, "the incremental take of the unchanged bulk state wrote data")
    record = {
        "card": card, "bytes": nbytes, "blocks": n_blocks, "take_s": take_s,
        "restore_s": restore_s, "take_gb_s": nbytes / take_s / 1e9,
        "restore_gb_s": nbytes / restore_s / 1e9, "phases_s": phases,
        "digest_take_s": digest_take_s, "incremental_take_s": incr_take_s,
    }
    log(
        f"bulk: {nbytes / 2**30:.2f} GiB in {n_blocks} blocks: take {take_s:.3f} s "
        f"({record['take_gb_s']:.2f} GB/s), restore {restore_s:.3f} s "
        f"({record['restore_gb_s']:.2f} GB/s); digest-recording take {digest_take_s:.3f} s, "
        f"incremental take of the unchanged state {incr_take_s:.3f} s (no data written) on "
        f"{card}; bitwise equal"
    )
    print(json.dumps({"bulk": record}), flush=True)
    for p in (path_d, path_i):
        shutil.rmtree(p, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
