"""The four-rank cell's tiny run on the CPU gives each per-layer reader of
the program's own spans and counters listed for it a number. The
one-rank cells' runs are in the repo's ``tests/test_torch_portbench_spans.py``."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
CELL = "pythia-160m.ddp4_sync_save"
NEW = (
    "manager_save_s", "manager_async_call_ms", "manager_restore_s", "manager_commit_s",
    "manager_bookkeeping_s", "restore_place_s", "read_service_GBps", "write_service_GBps",
    "drain_cpu_s", "capture_GB_s",
)


def test_four_ranks_give_each_new_reader_a_number(tiny_root):
    """In a fresh process: the port caches its process group per process."""
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        listed = {m["name"]: m.get("workloads") for m in json.load(f)["per_layer"]}
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = {[HERE, BENCH, os.path.dirname(BENCH)]!r}
        from harness.cell import run_cell
        from harness.spec import load_cell
        cell = load_cell({tiny_root!r}, {CELL!r})
        rec = run_cell({tiny_root!r}, cell, 2**31 + 41, 1.0, False)[0]
        print("RESULT", json.dumps({{m.name: m.reader(rec) for m in cell.per_layer}}))
    """)
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    lines = [line for line in done.stdout.splitlines() if line.startswith("RESULT")]
    assert done.returncode == 0 and lines, done.stderr[-3000:]
    values = json.loads(lines[-1].split(" ", 1)[1])
    for name in NEW:
        if CELL in listed[name]:
            assert isinstance(values[name], float) and values[name] > 0, (name, values)
        else:
            assert name not in values
