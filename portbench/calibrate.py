#!/usr/bin/env python3
"""Readings that the training check's limits are set from; not run by the
benchmark's own runs.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control 3 --out <file.json>

For each seed, the program's first three steps (the cell's own set-up:
``harness.cell.train_warmup``, at the cell's sizes) against the plain
reference in float32: the lower readings. On the first ``--control``
seeds, three things put in the program's place and read the same way:
the reference computed in float8 (the control: the precision below the
configuration's bfloat16), the program fed half of each batch, its loss
the mean over that half, and a step that returns the state unchanged (two
faults; the latter's change gap reads 1 by definition, its loss gap is
read). One process, one card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def half_batch(step):
    def wrapped(state, tokens):
        return step(state, tokens[: tokens.shape[0] // 2])

    return wrapped


def state_unchanged(step):
    """The fault of a step that returns its state as it was (its loss the
    step's own): every tensor of the state put back after the step."""
    import torch
    from harness.data import flatten

    def wrapped(state, tokens):
        tensors = [t for t in flatten(state.state_dict()).values() if isinstance(t, torch.Tensor)]
        before = [t.clone() for t in tensors]
        state, loss = step(state, tokens)
        with torch.no_grad():
            for t, b in zip(tensors, before):
                t.copy_(b)
        return state, loss

    return wrapped


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    sys.path[:0] = [HERE, ROOT]
    import torch

    from harness import check
    from harness.cell import train_warmup
    from harness.spec import load_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = load_cell(ROOT, args.workload)
    d, adamw = cell.dims, cell.config["run"]["adamw"]

    def reference(seed, batches, compute):
        weights = cell.weights(seed, device)
        out = cell.reference.train_readings(
            weights, batches, d, lr=adamw["lr"], betas=adamw["betas"], eps=adamw["eps"],
            weight_decay=adamw["weight_decay"], compute=compute, keep_first_grads=True,
        )
        del weights
        return out

    def program(seed, wrap=None):
        t = train_warmup(cell, seed, device, wrap)
        got = (t.losses, t.grad_norms, t.change_norms, [b.clone() for b in t.batches], t.first_moments, t.first_scale)
        del t
        gc.collect()
        torch.cuda.empty_cache()
        return got

    def gaps(losses, grads, changes, ref, first, scale=1.0):
        g = check.training_gaps(losses, grads, changes, ref, first, scale)
        return {k: g[k] for k in ("loss_gap", "grad_gap", "change_gap", "grad_diff", "grad_leaf", "change_leaf", "diff_leaf")}

    rows = {"program": [], "control_fp8": [], "half_batch": [], "state_unchanged": []}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.monotonic()
        losses, grads, changes, batches, first, scale = program(seed)
        t1 = time.monotonic()
        ref = reference(seed, batches, "f32")
        t2 = time.monotonic()
        rows["program"].append({"seed": seed, **gaps(losses, grads, changes, ref, first, scale),
                                "program_s": t1 - t0, "reference_s": t2 - t1, "losses": losses,
                                "reference_losses": ref.losses})
        print(json.dumps({"program": rows["program"][-1]}), flush=True)
        if i < args.control:
            ctl = reference(seed, batches, "fp8")
            rows["control_fp8"].append({"seed": seed, **gaps(ctl.losses, ctl.grad_norms, ctl.change_norms, ref, ctl.first_grads),
                                        "losses": ctl.losses})
            del ctl
            print(json.dumps({"control_fp8": rows["control_fp8"][-1]}), flush=True)
            h_losses, h_grads, h_changes, _, h_first, _ = program(seed, half_batch)
            rows["half_batch"].append({"seed": seed, **gaps(h_losses, h_grads, h_changes, ref, h_first, scale), "losses": h_losses})
            print(json.dumps({"half_batch": rows["half_batch"][-1]}), flush=True)
            u_losses, u_grads, u_changes, _, u_first, _ = program(seed, state_unchanged)
            rows["state_unchanged"].append({"seed": seed, **gaps(u_losses, u_grads, u_changes, ref, u_first, scale), "losses": u_losses})
            print(json.dumps({"state_unchanged": rows["state_unchanged"][-1]}), flush=True)
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    summary = {}
    for name in ("loss_gap", "grad_gap", "change_gap", "grad_diff"):
        summary[name] = {
            "lower": max(r[name] for r in rows["program"]),
            "control_min": min((r[name] for r in rows["control_fp8"]), default=None),
            "half_batch_min": min((r[name] for r in rows["half_batch"]), default=None),
            "state_unchanged_min": min((r[name] for r in rows["state_unchanged"]), default=None),
        }
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(0), "rows": rows, "summary": summary}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
