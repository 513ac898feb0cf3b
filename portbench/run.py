#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics come from ``BENCHMARK.json``; see ``portbench/README.md``.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the compared numbers.
"""

import time

T_TOP = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from harness.guard import forbidden_modules  # noqa: E402

CACHE = os.path.join(ROOT, ".portbench_cache")


def process_age_s() -> float:
    """Seconds since this process started, from /proc (the interpreter's
    own start-up included); 0 where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_TOP = process_age_s()


def loaded_forbidden(results) -> dict:
    """Each rank's forbidden modules once its window has closed: this
    process's for rank 0, what every other rank recorded in its own."""
    found = {0: forbidden_modules()}
    found.update({r.rank: r.forbidden for r in results[1:]})
    return {rank: mods for rank, mods in found.items() if mods}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    from harness.spec import load_cell

    cell = load_cell(ROOT, args.workload)
    # Every build and kernel cache at a fixed path inside the checkout.
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
    os.environ.update(cell.config["run"].get("knobs", {}))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); found {n}", file=sys.stderr)
        return 3
    if not os.path.isdir(os.path.join(ROOT, "torchsnapshot_tpu_torch")):
        print("portbench: the program (torchsnapshot_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from harness.cell import reckoned_written_bytes, run_cell, end_to_end

    rec, r0, results, correct, compared, failed, notes = run_cell(
        ROOT, cell, args.seed, args.seconds, bool(args.trace)
    )
    setup_s = AGE_AT_TOP + (r0.setup_done_s - T_TOP)
    written = sum(r.written_total for r in results)
    print(
        f"portbench: {cell.name} seed {args.seed}: storage_write_bytes_total {written:.0f} bytes "
        f"over {len(results)} rank(s); reckoned {reckoned_written_bytes(cell)} bytes of state "
        f"plus manifests, checksum tables and records"
    )
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = m.reader(rec)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        values = end_to_end(cell, rec, setup_s)
        for m in cell.end_to_end:
            if m.name in values:
                metrics[m.name] = {"value": values[m.name], "unit": m.unit}
    device = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
        "memory_peak_bytes": max(r.memory_peak_bytes for r in results),
    }
    out = {
        "correct": correct,
        "attempted": len(rec["saves"]) + len(rec["restores"]) + sum(rec["step_counts"]),
        "failed": failed, "metrics": metrics, "device": device,
    }
    traces = [r.trace for r in results]
    if args.trace and all(t is not None for t in traces):
        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        out["breakdown"] = {"device_ops": traces[0]["device_ops"], "idle_gaps": traces[0]["idle_gaps"]}
    elif args.trace:
        notes.append("torch.profiler recorded no device time on some rank: busy_s and the trace metrics not measured")
    out["checks"] = compared
    found = loaded_forbidden(results)
    if found:
        where = "; ".join(f"rank {rank} loaded {mods}" for rank, mods in sorted(found.items()))
        print(f"portbench: {where}: the benchmark runs the port alone", file=sys.stderr)
        return 4
    for line in notes:
        print(f"portbench: {line}", file=sys.stderr)
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
