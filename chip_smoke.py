#!/usr/bin/env python3
"""Smoke run of torchsnapshot_tpu_torch on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card; without one it exits non-zero and prints no result. Phases,
each of which raises on failure (nothing is caught):

1. **kernels**: build every CUDA kernel under
   ``torchsnapshot_tpu_torch/csrc`` and hold each against its plain PyTorch
   version on the card, at the training shape and a long-sequence shape,
   in bf16 and f32; time kernel, plain version and the library call.
   The host I/O runtime (``native/ts_io.cpp``) is built here too, so the
   timed takes and restores below hold no compile.
2. **main**: the port's main path. Train the widest in-repo transformer
   (d_model 1024, 8 layers, flash attention, bf16) for a few AdamW steps,
   ``Snapshot.take`` the train state, ``Snapshot.restore`` it into a fresh
   model and optimizer built from another seed, and check that every
   tensor, the step and the RNG state came back bit for bit, that the
   evaluation logits of both agree bit for bit, and that one more training
   step gives the same loss on both. The kernels' launch counters are set
   to 0 just before and read just after: the path must have launched both.
3. **bulk**: take and restore a bulk bf16 state of (16384, 8192) blocks
   (8 GiB by default, ``--bulk-gib 20`` for the reference's 20 GB figure)
   with a bitwise check.

The second-to-last line of stdout is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Tolerances (rtol, atol) of kernel against plain version, same inputs on
# the card.
# f32: the same f32 algorithm, summed in another order (64-wide tiles and
# FMA contraction against 128-wide tiles and separate multiply-adds), so a
# few f32 ulps of the row sums. The chunk kernel's outputs are f32 whatever
# the input dtype, so they are always held to this.
# bf16 (the fused kernel's output): both sides compute in f32 from the same
# bf16 inputs, agreeing to the f32 tolerance, and round to bf16 once; each
# rounding moves a value by at most half a bf16 ulp, so the two differ by at
# most one ulp, 2^-7 of the value (8 bits of significand). rtol 8e-3 is
# just above that; atol is the f32 tolerance, for values near 0.
F32_TOL = 2e-5
TOLERANCE = {"float32": (F32_TOL, F32_TOL), "bfloat16": (8e-3, F32_TOL)}

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
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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


# ----------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ----------------------------------------------------------------------


def _qkv(shape, dtype, seed: int, fused_qkv: bool):
    """q, k, v on the card from a seed. With ``fused_qkv`` they are the
    strided slices of one (b, s, 3, h, d) tensor, as the model makes them."""
    import torch

    b, s, h, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused_qkv:
        qkv = torch.randn((b, s, 3, h, d), generator=g, device="cuda").to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return tuple(
        torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)
    )


def kernel_phase(seed: int) -> dict:
    """Hold both kernels against their plain versions; returns the
    per-kernel record at the main path's shape (bf16, (8, 1024, 16, 64))."""
    import torch
    import torch.nn.functional as F

    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    cases = [
        ((8, 1024, 16, 64), torch.bfloat16, True),  # the main path's call
        ((8, 1024, 16, 64), torch.float32, False),
        ((2, 4096, 16, 128), torch.bfloat16, False),
        ((2, 4096, 16, 128), torch.float32, False),
    ]
    records = {}
    for shape, dtype, main_shape in cases:
        b, s, h, d = shape
        dt = str(dtype).split(".")[1]
        rtol, atol = TOLERANCE[dt]
        q, k, v = _qkv(shape, dtype, seed, fused_qkv=main_shape)
        itemsize = q.element_size()
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

        library_ms = cuda_ms(sdpa)
        flops = fa.attention_flops(b, h, s, s, d, causal=True)
        op_ms = flops / PEAK_FLOPS[dt] * 1e3

        # fused kernel
        out = fa.flash_causal_forward(q, k, v)
        ref = fa.flash_causal_forward_plain(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
        nbytes = 4 * b * s * h * d * itemsize
        rec_fwd = {
            "ms": cuda_ms(lambda: fa.flash_causal_forward(q, k, v)),
            "plain_ms": cuda_ms(lambda: fa.flash_causal_forward_plain(q, k, v), iters=3),
            "library_ms": library_ms,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S * 1e3, op_ms),
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S * 1e3 > op_ms else "operations",
            "max_abs_err": err,
        }

        # chunk kernel (causal, the training forward; unmasked, the ring step)
        for causal in (True, False):
            o, m, l = fa.flash_attention_chunk(q, k, v, causal=causal)
            ro, rm, rl = fa.flash_attention_chunk_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            # Both sides are f32 from the same inputs, whatever the input
            # dtype: the f32 tolerance holds. The accumulator and l grow
            # with the number of visible keys, so the output is compared
            # normalized and l relative to its size.
            on, rn = o / l[..., None], ro / rl[..., None]
            err_c = max((on - rn).abs().max().item(), (m - rm).abs().max().item())
            torch.testing.assert_close(on, rn, rtol=F32_TOL, atol=F32_TOL)
            torch.testing.assert_close(m, rm, rtol=F32_TOL, atol=F32_TOL)
            torch.testing.assert_close(l, rl, rtol=F32_TOL, atol=0.0)
            if causal:
                err_causal = err_c
        nbytes_c = 3 * b * s * h * d * itemsize + 4 * b * h * s * (d + 2)
        rec_chunk = {
            "ms": cuda_ms(lambda: fa.flash_attention_chunk(q, k, v, causal=True)),
            "plain_ms": cuda_ms(
                lambda: fa.flash_attention_chunk_plain(q, k, v, causal=True), iters=3
            ),
            "library_ms": library_ms,
            "bound_ms": max(nbytes_c / HBM_BYTES_PER_S * 1e3, op_ms),
            "bound_by": "bytes" if nbytes_c / HBM_BYTES_PER_S * 1e3 > op_ms else "operations",
            "max_abs_err": err_causal,
        }
        for name, rec in (("flash_fwd", rec_fwd), ("flash_chunk", rec_chunk)):
            log(
                f"kernel {name} {tuple(shape)} {dt}: {rec['ms']:.4f} ms "
                f"(plain {rec['plain_ms']:.4f} ms, SDPA {rec['library_ms']:.4f} ms, "
                f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}), "
                f"max |err| {rec['max_abs_err']:.3e} "
                f"(fused rtol {rtol} atol {atol}; chunk {F32_TOL})"
            )
        if main_shape:
            records = {"flash_fwd": rec_fwd, "flash_chunk": rec_chunk}
        del q, k, v, qh, kh, vh
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
}


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
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    # The host I/O runtime (pwritev, CRC32-C) also compiles at first use;
    # build it here so that the timed take and restore hold no compile.
    from torchsnapshot_tpu_torch import _native

    t0 = time.monotonic()
    _require(_native.lib() is not None, "the native I/O runtime did not build")
    log(f"native I/O runtime: {time.monotonic() - t0:.1f} s to build and load")

    records = {}
    if "kernels" in phases:
        records = kernel_phase(args.seed)

    # Launches are counted only in the main path's run; without it they
    # were not measured and the record says null.
    launches = dict.fromkeys(fa.launch_counts)
    work_dir = tempfile.mkdtemp(prefix="ts_chip_smoke_")
    try:
        if "main" in phases:
            launches = main_phase(args, work_dir, card)
        if "bulk" in phases:
            bulk_phase(args, work_dir, card)
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


def main_phase(args, work_dir: str, card: str) -> dict:
    """Train, take, restore into a fresh state, and check the restored
    run continues bit for bit. Returns the kernels' launch counts of the
    run."""
    import torch

    from torchsnapshot_tpu_torch import RngState, Snapshot, telemetry
    from torchsnapshot_tpu_torch.models.transformer import (
        TransformerConfig,
        init_train_state,
        make_train_step,
        random_tokens,
    )
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    # The widest transformer the repo runs (benchmarks/pod/main.py).
    cfg = TransformerConfig(
        vocab_size=32768, d_model=1024, n_heads=16, n_layers=N_LAYERS,
        d_ff=4096, dtype=torch.bfloat16, attn_impl="flash",
    )
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, args.seed)).cuda()
    torch.manual_seed(args.seed)  # the global generators RngState holds
    state = init_train_state(cfg, seed=args.seed)
    train_step = make_train_step(cfg)

    fa.reset_launch_counts()
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
    telemetry.metrics().reset_phase_timings()
    t0 = time.monotonic()
    Snapshot.take(path, {"train": state, "rng": RngState()})
    take_s = time.monotonic() - t0
    # Seconds from the write pipeline's start to the end of each phase.
    take_phases = telemetry.metrics().last_phase_timings()
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
    _, loss_b = train_step(fresh, tokens)
    torch.cuda.synchronize()
    _require(same_bits(loss_a, loss_b), f"next-step losses differ: {loss_a} vs {loss_b}")
    for (name, a), (_, b) in zip(state.model.named_parameters(), fresh.model.named_parameters()):
        _require(same_bits(a, b), f"parameter {name} differs after the next step")
    launches = dict(fa.launch_counts)
    _require(all(launches.values()), f"a kernel of the path never launched: {launches}")

    snap_bytes = sum(
        os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs
    )
    record = {
        "card": card, "params": n_params, "train_state_bytes": state_bytes,
        "snapshot_bytes": snap_bytes, "take_s": take_s, "restore_s": restore_s,
        "take_gb_s": state_bytes / take_s / 1e9, "restore_gb_s": state_bytes / restore_s / 1e9,
        "take_again_s": take_again_s, "take_again_gb_s": state_bytes / take_again_s / 1e9,
        "take_phases_s": take_phases, "step_ms": step_s * 1e3, "losses": losses,
        "next_loss": float(loss_a), "launches": launches,
    }
    log(
        f"main: take {take_s:.3f} s ({record['take_gb_s']:.2f} GB/s; again "
        f"{take_again_s:.3f} s, {record['take_again_gb_s']:.2f} GB/s), restore "
        f"{restore_s:.3f} s ({record['restore_gb_s']:.2f} GB/s) of {state_bytes / 1e9:.3f} GB "
        f"on {card}; restored state, logits and next-step loss {float(loss_a)!r} bit-identical; "
        f"launches {launches}"
    )
    print(json.dumps({"main": record}), flush=True)
    shutil.rmtree(path, ignore_errors=True)
    del state, fresh
    torch.cuda.empty_cache()
    return launches


def bulk_phase(args, work_dir: str, card: str) -> None:
    """Take and restore bf16 (16384, 8192) blocks shaped like bench.py's
    make_state, with a bitwise check."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, telemetry

    block = (16384, 8192)
    block_bytes = block[0] * block[1] * 2
    n_blocks = max(1, int(args.bulk_gib * 2**30) // block_bytes)
    free = shutil.disk_usage(work_dir).free
    _require(
        free > n_blocks * block_bytes * 1.1,
        f"{work_dir} has {free / 2**30:.1f} GiB free; the bulk phase needs "
        f"{n_blocks * block_bytes / 2**30:.1f} GiB",
    )
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    state = {
        f"w{i}": torch.randn(block, generator=g, device="cuda", dtype=torch.bfloat16)
        for i in range(n_blocks)
    }
    state["bias"] = torch.ones(65536, device="cuda")
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    path = os.path.join(work_dir, "bulk")
    torch.cuda.synchronize()
    telemetry.metrics().reset_phase_timings()
    t0 = time.monotonic()
    Snapshot.take(path, {"bulk": TensorTreeState(state)})
    take_s = time.monotonic() - t0
    phases = telemetry.metrics().last_phase_timings()

    target = {k: torch.zeros_like(v) for k, v in state.items()}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(path).restore({"bulk": TensorTreeState(target)})
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    phases.update(telemetry.metrics().last_phase_timings())
    for k in state:
        _require(same_bits(state[k], target[k]), f"bulk block {k} differs after restore")
    record = {
        "card": card, "bytes": nbytes, "blocks": n_blocks, "take_s": take_s,
        "restore_s": restore_s, "take_gb_s": nbytes / take_s / 1e9,
        "restore_gb_s": nbytes / restore_s / 1e9, "phases_s": phases,
    }
    log(
        f"bulk: {nbytes / 2**30:.2f} GiB in {n_blocks} blocks: take {take_s:.3f} s "
        f"({record['take_gb_s']:.2f} GB/s), restore {restore_s:.3f} s "
        f"({record['restore_gb_s']:.2f} GB/s) on {card}; bitwise equal"
    )
    print(json.dumps({"bulk": record}), flush=True)
    shutil.rmtree(path, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
