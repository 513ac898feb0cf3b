"""A second architecture is taken as files alone: the port's soft-routed MoE
transformer (``soft_moe/arch.py`` and ``soft_moe/reference.py`` beside this
file) becomes ``archs/soft_moe.py`` and ``reference/soft_moe.py`` of a tiny
copy of the benchmark, with a configuration and a cell entry, and runs
with no file of the harness changed."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import pytest

from harness.cell import run_cell
from harness.spec import load_arch, load_cell
from tinybench import BENCH, HERE, REPO

FIXTURE = os.path.join(HERE, "soft_moe")
CELL = "soft-moe.sync_save"
# What runs a cell: every file of the benchmark that is not one of its data
# files (a configuration, a traffic mix, a metric, an adapter, a reference).
HARNESS = ("harness", "run.py", "calibrate.py", "trace_spans.py")


def _digests(top, subs=None):
    out = {}
    for sub in subs or [""]:
        path = os.path.join(top, sub)
        walk = [(os.path.dirname(path), [], [os.path.basename(path)])] if os.path.isfile(path) else os.walk(path)
        for d, _, files in walk:
            for f in files:
                if "__pycache__" not in d and not f.endswith(".pyc"):
                    with open(os.path.join(d, f), "rb") as fh:
                        out[os.path.relpath(os.path.join(d, f), top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _add_soft_moe(root):
    """The architecture's files, a configuration and a cell, into ``root``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    home = os.path.join(root, bench["paths"][0])
    shutil.copy(os.path.join(FIXTURE, "arch.py"), os.path.join(home, "archs", "soft_moe.py"))
    shutil.copy(os.path.join(FIXTURE, "reference.py"), os.path.join(home, "reference", "soft_moe.py"))
    with open(os.path.join(REPO, "portbench", "configs", "pythia-160m.json")) as f:
        cfg = json.load(f)
    cfg.update(name="soft-moe", architecture="soft_moe", num_local_experts=4, moe_every=2)
    cfg = load_arch(home, cfg).tiny(cfg)
    with open(os.path.join(home, "configs", "soft-moe.json"), "w") as f:
        json.dump(cfg, f)
    bench["configs"].append({
        "name": "soft-moe", "source": "https://example.org/soft-moe", "file": "portbench/configs/soft-moe.json",
        "reduced": [], "why": "an architecture added as files",
    })
    bench["workloads"].append({
        "name": CELL, "config": "soft-moe", "traffic": "sync_save", "chips": 1, "why": "a cell of the new architecture",
    })
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return home


def test_a_second_architecture_runs_correct_with_no_harness_file_changed(tiny_root):
    harness_before = _digests(BENCH, HARNESS)
    fresh = _digests(tiny_root)
    home = _add_soft_moe(tiny_root)
    cell = load_cell(tiny_root, CELL)
    assert cell.arch.__name__.endswith("soft_moe") and cell.reference.__name__.endswith("soft_moe")
    leaves = cell.leaves
    assert [k for k in leaves if k.endswith("router")] == ["layers/1/router"]
    assert leaves["layers/1/w_in"].shape == (4, 64, 256) and leaves["layers/0/w_in"].shape == (64, 256)

    rec, _, _, correct, compared, _, _ = run_cell(tiny_root, cell, 2**31 + 29, 1.0, False)
    assert correct, compared
    assert rec["flops_per_step"] == cell.arch.step_flops(cell.dims) and rec["tokens_per_step"] == 256
    assert {"flash_chunk_bound_s", "flash_bwd_bound_s"} <= set(rec)

    # The tiny copy gained files and entries; the harness is as it was.
    after = _digests(tiny_root)
    assert {k for k in fresh if after.get(k) != fresh[k]} == {"BENCHMARK.json"}
    assert set(after) - set(fresh) == {
        os.path.relpath(os.path.join(home, p), tiny_root)
        for p in ("archs/soft_moe.py", "reference/soft_moe.py", "configs/soft-moe.json")
    }
    assert _digests(BENCH, HARNESS) == harness_before


def test_the_adapter_counts_the_programs_state(tiny_root):
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig, init_train_state

    _add_soft_moe(tiny_root)
    cell = load_cell(tiny_root, CELL)
    d = cell.dims
    state = init_train_state(TransformerConfig(vocab_size=d.vocab, d_model=d.d_model, n_heads=d.n_heads,
                                               n_layers=d.n_layers, d_ff=d.d_ff, n_experts=4, moe_every=2),
                             device="cpu")
    params = list(state.model.parameters())
    assert cell.arch.param_count(d) == sum(p.numel() for p in params)
    assert cell.arch.leaf_count(d) == 3 * len(params)
    assert cell.arch.state_bytes(d) == 3 * sum(p.numel() * p.element_size() for p in params)


def test_dropping_the_router_gradient_in_the_reference_is_not_correct(tiny_root):
    home = _add_soft_moe(tiny_root)
    path = os.path.join(home, "reference", "soft_moe.py")
    with open(path) as f:
        src = f.read()
    line = 'router = p[blk + "router"]'
    assert src.count(line) == 1
    with open(path, "w") as f:
        f.write(src.replace(line, line + ".detach()"))
    cell = load_cell(tiny_root, CELL)
    _, _, _, correct, compared, _, notes = run_cell(tiny_root, cell, 2**31 + 29, 1.0, False)
    assert not correct, compared
    assert compared["grad_gap"]["value"] > compared["grad_gap"]["limit"], compared
    assert any("layers/1/router" in n for n in notes), notes


@pytest.mark.parametrize("missing", ["kernels", "tiny"])
def test_an_adapter_without_a_part_is_refused(tiny_root, missing):
    home = _add_soft_moe(tiny_root)
    path = os.path.join(home, "archs", "soft_moe.py")
    with open(path) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write(src.replace(f"def {missing}(", f"def _{missing}("))
    with pytest.raises(ValueError, match=missing):
        load_cell(tiny_root, CELL)
