"""The harness finds configurations, traffic mixes, cells and per-layer
metrics by name, and takes new ones added as files and entries alone."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from harness.cell import run_cell
from harness.spec import load_cell
from tinybench import REPO


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_loads_with_its_files(cell):
    c = load_cell(REPO, cell)
    assert c.traffic["loop"] in ("save", "restart")
    assert c.per_layer and all(callable(m.reader) for m in c.per_layer)
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and {n.split(".")[0] for n in names} == {"tokens_per_s", "setup_s"}
    # every per-layer metric's moved metric is reported by the cell
    assert all(m.moves in names for m in c.per_layer)


def test_a_split_metric_reads_as_its_quantity():
    """``tokens_per_s.restart`` is the restart cell's tokens_per_s, and each
    ``<metric>.restart`` reader reads what ``<metric>`` reads."""
    from harness.cell import end_to_end

    cell = load_cell(REPO, "pythia-410m.restart")
    rec = {"step_counts": [30], "tokens_per_step": 8192, "window_s": 20.0}
    assert end_to_end(cell, rec, 25.0) == {"tokens_per_s.restart": 30 * 8192 / 20.0, "setup_s": 25.0}
    sync = load_cell(REPO, "pythia-160m.sync_save")
    assert set(end_to_end(sync, rec, 25.0)) == {"tokens_per_s", "setup_s"}
    readers = {m.name: m.reader for m in cell.per_layer}
    record = {"steps": [(0.5, "step"), (0.7, "step"), (0.6, "step")],
              "traces": [{"busy_s": 6.0, "window_s": 10.0}]}
    base = {m.name: m.reader for m in sync.per_layer}
    for name in ("step_ms_clean", "device_idle_pct"):
        assert readers[f"{name}.restart"](record) == base[name](record)
    assert readers["step_ms_clean.restart"](record) == pytest.approx(600.0)


def test_a_new_config_mix_cell_and_metric_are_taken_as_files(tiny_root):
    root = tiny_root
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    home = os.path.join(root, bench["paths"][0])
    # a configuration: a copy of one under a new name
    shutil.copy(os.path.join(home, "configs", "pythia-160m.json"), os.path.join(home, "configs", "extra.json"))
    bench["configs"].append({
        "name": "extra", "source": "https://example.org/extra", "file": "portbench/configs/extra.json",
        "reduced": [], "why": "a configuration added as a file",
    })
    # a traffic mix: one save at the middle of the window
    with open(os.path.join(home, "traffic", "one_save.json"), "w") as f:
        json.dump({"loop": "save", "mode": "sync", "marks": [0.5]}, f)
    bench["workloads"].append({
        "name": "extra.one_save", "config": "extra", "traffic": "one_save", "chips": 1,
        "why": "a cell added as an entry",
    })
    # a per-layer metric: its reader is a file of its own
    with open(os.path.join(home, "metrics", "saves_seen.py"), "w") as f:
        f.write("def read(rec):\n    return float(len(rec['saves'])) or None\n")
    bench["per_layer"].append({
        "name": "saves_seen", "unit": "saves", "better": "higher", "source": "host_clock",
        "layer": "training loop (manager.py)", "moves": "tokens_per_s", "workloads": ["extra.one_save"],
    })
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = load_cell(root, "extra.one_save")
    assert cell.config_name == "extra" and cell.traffic["marks"] == [0.5]
    assert [m.name for m in cell.per_layer if m.name == "saves_seen"] == ["saves_seen"]
    rec, _, _, correct, compared, _, _ = run_cell(root, cell, 11, 1.0, False)
    assert correct, compared
    reader = {m.name: m.reader for m in cell.per_layer}["saves_seen"]
    assert reader(rec) == 1.0
    # a metric listed for other cells stays out of this one
    assert "drain_step_ms" not in {m.name for m in cell.per_layer}


def test_unknown_loop_kind_is_refused(tiny_root):
    home = os.path.join(tiny_root, "portbench")
    with open(os.path.join(home, "traffic", "sync_save.json")) as f:
        t = json.load(f)
    t["loop"] = "serve"
    with open(os.path.join(home, "traffic", "sync_save.json"), "w") as f:
        json.dump(t, f)
    with pytest.raises(ValueError, match="loop"):
        load_cell(tiny_root, "pythia-160m.sync_save")
