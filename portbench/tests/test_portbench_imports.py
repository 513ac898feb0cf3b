"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module name (the port's name begins with the JAX package's);
the reference also loads nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap

import pytest

from tinybench import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "torchsnapshot_tpu"}
PORT = "torchsnapshot_tpu_torch"


def _sources(sub=""):
    top = os.path.join(BENCH, sub)
    for dirpath, _, files in os.walk(top):
        if os.path.basename(dirpath) in ("tests", "__pycache__"):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_sources_import_no_jax(path):
    assert not set(_imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    tops = set(_imported_tops(path))
    assert PORT not in tops and "harness" not in tops


def test_run_checks_whole_names():
    sys.path.insert(0, BENCH)
    import run

    sys.modules.setdefault("torchsnapshot_tpu_torch_fake_probe", object())
    assert "torchsnapshot_tpu" not in run.forbidden_modules()
    sys.modules["jaxlib_lookalike"] = object()
    try:
        assert run.forbidden_modules() == []
    finally:
        del sys.modules["jaxlib_lookalike"]


def _run(code):
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True, timeout=600,
        cwd=REPO, env={**os.environ, "PYTHONPATH": os.pathsep.join([BENCH, REPO, os.path.dirname(__file__)])},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_whole_tiny_run_loads_no_jax(tmp_path):
    last = _run(f"""
        import sys
        from tinybench import make_tiny_root
        from harness.spec import load_cell
        from harness.cell import run_cell
        root = make_tiny_root({str(tmp_path)!r})
        out = run_cell(root, load_cell(root, "pythia-160m.async_save"), 5, 1.0, False)
        assert out[3], out[4]
        print(sorted({{m.split(".")[0] for m in sys.modules}} & set({sorted(FORBIDDEN)!r})))
    """)
    assert last == "[]"


def plant_jax_in_spawned_ranks():
    """Run first in every rank: a spawned rank (not rank 0) loads a module
    named ``jax``."""
    import multiprocessing
    import types

    if multiprocessing.parent_process() is not None:
        sys.modules["jax"] = types.ModuleType("jax")


def add_two_rank_cell(root):
    """A two-rank cell of the tiny copy: one replicated save a window."""
    import json

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(root, bench["paths"][0], "traffic", "two_ranks.json"), "w") as f:
        json.dump({"loop": "save", "mode": "sync", "marks": [0.5], "ranks": 2, "replicated": ["**"]}, f)
    bench["workloads"].append({
        "name": "pythia-160m.two_ranks", "config": "pythia-160m", "traffic": "two_ranks", "chips": 2,
        "why": "two ranks on the CPU",
    })
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


@pytest.mark.parametrize("plant, found", [
    (None, "{}"), ("plant_jax_in_spawned_ranks", "{1: ['jax']}"),
], ids=["sound", "jax_in_rank_1"])
def test_every_rank_is_held_to_the_import_check(tmp_path, plant, found):
    """A module loaded by a spawned rank reaches the refusal, not only rank 0's."""
    init = f"t.{plant}" if plant else "None"
    last = _run(f"""
        import run
        import test_portbench_imports as t
        from tinybench import make_tiny_root
        from harness.spec import load_cell
        from harness.cell import run_cell
        root = make_tiny_root({str(tmp_path)!r})
        t.add_two_rank_cell(root)
        out = run_cell(root, load_cell(root, "pythia-160m.two_ranks"), 2**32 + 3, 1.0, False, init={init})
        assert out[3], out[4]
        print(run.loaded_forbidden(out[2]))
    """)
    assert last == found


def test_the_reference_loads_nothing_of_the_port(tmp_path):
    last = _run(f"""
        import sys, torch
        from types import SimpleNamespace
        from reference.model import train_readings
        from reference.reader import read_snapshot
        w = {{"embed": torch.randn(64, 16, dtype=torch.bfloat16), "unembed": torch.randn(16, 64, dtype=torch.bfloat16),
             "ln_f_scale": torch.ones(16, dtype=torch.bfloat16)}}
        dims = SimpleNamespace(d_model=16, n_heads=2, n_layers=0)
        r = train_readings(w, [torch.randint(0, 64, (2, 8))], dims, 1e-3, (0.9, 0.999), 1e-8, 1e-4)
        assert len(r.losses) == 1
        tops = {{m.split(".")[0] for m in sys.modules}}
        print(sorted(tops & set({sorted(FORBIDDEN | {PORT, "harness"})!r})))
    """)
    assert last == "[]"
