#!/usr/bin/env python3
"""Paired timing of two trees of the repository on one CUDA card.

Compares a change with its parent in one machine, in turns (parent, change,
change, parent), so that the card, its power limit and the host are the
same for both:

    git add -A
    python3 chip_paired.py prepare PARENT_REV     # in the git checkout
    python3 chip_paired.py run                     # on the card

``prepare`` unpacks ``git archive PARENT_REV`` and the index's tree
(``git write-tree``) under ``build/paired/{parent,change}``. ``run`` takes
each turn from its tree's own directory: that tree's ``chip_smoke.py``
(all phases), then this script's ``time`` on that tree,
which times the tree's two flash wrappers in bf16 and f32 at the main path's
shape and at (2, 4096, 16, 128), its digest wrapper ``digest_many_async``
on the train state's and the bulk state's chunk tables, and its pack
wrapper ``pack_async`` called with plain specs (the call both trees take)
on the train state's largest slab, 10,000 members of 4 KiB and 10,000 of
4,093 bytes, with one method for both trees: back-to-back ms, the card's
ms behind a spin kernel and the host's us per call; for the digest also
the card's time split by the profiler into the main kernel and the rest,
and the SM clock and power while it ran; for the pack also the host's us
to build its table, and the same times for a call given the slab's
``PackLayout`` where the tree has one. Each turn's output goes to
``chiprun_out/paired/<turn>_<tree>.log``; its kernel lines and JSON records
are printed too.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PAIRED = os.path.join(HERE, "build", "paired")
OUT = os.path.join(HERE, "chiprun_out", "paired")
TURNS = ("parent", "change", "change", "parent")
# q/k/v as slices of one fused projection: the main path's call, and the
# long-sequence shape at d = 128; each in both input dtypes.
SHAPES = ((8, 1024, 16, 64), (2, 4096, 16, 128))
DTYPES = ("bfloat16", "float32")


def prepare(parent_rev: str) -> None:
    tree = subprocess.run(
        ["git", "write-tree"], cwd=HERE, capture_output=True, text=True, check=True
    ).stdout.strip()
    for name, rev in (("parent", parent_rev), ("change", tree)):
        dst = os.path.join(PAIRED, name)
        shutil.rmtree(dst, ignore_errors=True)
        os.makedirs(dst)
        archive = subprocess.Popen(["git", "archive", rev], cwd=HERE, stdout=subprocess.PIPE)
        subprocess.run(["tar", "-x", "-C", dst], stdin=archive.stdout, check=True)
        if archive.wait() != 0:
            raise RuntimeError(f"git archive {rev} failed")
        print(f"{name}: {rev} -> {dst}")


def time_tree(tree: str) -> None:
    """Time ``tree``'s wrappers; prints one JSON line per shape and dtype."""
    import torch

    from chip_smoke import _qkv, cuda_ms, held_times  # this script's own copy

    sys.path.insert(0, tree)
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    if not fa.__file__.startswith(tree):
        raise RuntimeError(f"imported {fa.__file__}, not the package of {tree}")
    for shape in SHAPES:
        for dtype in DTYPES:
            q, k, v = _qkv(shape, getattr(torch, dtype), 0, True)
            rec = {"tree": tree, "shape": shape, "dtype": dtype}
            for name, fn in (
                ("flash_fwd", lambda: fa.flash_causal_forward(q, k, v)),
                ("flash_chunk", lambda: fa.flash_attention_chunk(q, k, v, causal=True)),
            ):
                device_ms, host_us = held_times(fn)
                rec[name] = {"ms": cuda_ms(fn), "device_ms": device_ms, "host_us": host_us}
            print(json.dumps({"paired_time": rec}), flush=True)
            del q, k, v
    time_digest(tree)
    time_pack(tree)


def time_pack(tree: str) -> None:
    """Time ``tree``'s pack wrapper on the three layouts of chip_smoke's
    ``pack_layouts``; one JSON line each."""
    from chip_smoke import pack_layouts, pack_timings
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    if not dp.__file__.startswith(tree):
        raise RuntimeError(f"imported {dp.__file__}, not the package of {tree}")
    for label, specs in pack_layouts(0):
        rec = {"tree": tree, "pack": label, **pack_timings(specs)}
        print(json.dumps({"paired_time": rec}), flush=True)


def time_digest(tree: str) -> None:
    """Time ``tree``'s digest wrapper on the train state's chunk table and
    the bulk state's (8 GiB); one JSON line each."""
    import torch

    from chip_smoke import _train_state_digest_specs, bulk_state, digest_timings
    from torchsnapshot_tpu_torch.flatten import flatten
    from torchsnapshot_tpu_torch.incremental import IncrementalTakeContext
    from torchsnapshot_tpu_torch.ops import device_digest as dd

    if not dd.__file__.startswith(tree):
        raise RuntimeError(f"imported {dd.__file__}, not the package of {tree}")
    device = torch.device("cuda", torch.cuda.current_device())
    state, specs = _train_state_digest_specs(0)
    bulk = bulk_state(0, 8.0)
    _, flat = flatten(bulk, prefix="bulk")
    bulk_specs = IncrementalTakeContext(None, None, None, 0).collect(flat)[device].specs
    for label, sp in (("train state", specs), ("bulk state", bulk_specs)):
        nbytes = dd.digest_bytes(sp)
        t = digest_timings(lambda: dd.digest_many_async(sp))
        rec = {"tree": tree, "digest": label, "rows": sum(1 if r is None else len(r) for _, r in sp),
               "bytes": nbytes, **t}
        print(json.dumps({"paired_time": rec}), flush=True)
    del state, specs, bulk, flat, bulk_specs


def run() -> int:
    os.makedirs(OUT, exist_ok=True)
    for i, name in enumerate(TURNS):
        tree = os.path.join(PAIRED, name)
        log_path = os.path.join(OUT, f"{i}_{name}.log")
        with open(log_path, "w") as log:
            for cmd in (
                [sys.executable, "chip_smoke.py"],
                [sys.executable, os.path.join(HERE, "chip_paired.py"), "time", tree],
            ):
                proc = subprocess.run(cmd, cwd=tree, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                log.write(proc.stdout)
                print(f"== turn {i} {name}: {' '.join(cmd[1:])} exited {proc.returncode}")
                for line in proc.stdout.splitlines():
                    if line.startswith(("kernel ", "{", "main:", "bulk:", "leaves:", "profile of")):
                        print(line)
                if proc.returncode != 0:
                    print(proc.stdout[-3000:])
                    return proc.returncode
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("prepare").add_argument("parent_rev")
    sub.add_parser("run")
    sub.add_parser("time").add_argument("tree")
    args = p.parse_args()
    if args.cmd == "prepare":
        prepare(args.parent_rev)
    elif args.cmd == "time":
        time_tree(os.path.abspath(args.tree))
    else:
        return run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
