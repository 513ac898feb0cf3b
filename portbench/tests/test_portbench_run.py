"""``run.py`` as a benchmark run calls it: no result without the cards the cell
asks for or without the program, and on a card one result line whose
``checks`` come last."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from tinybench import BENCH, REPO

ARGS = ["--workload", "pythia-160m.sync_save", "--seed", str(2**31 + 99), "--seconds", "3", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "portbench", "run.py"), *ARGS],
        cwd=cwd, capture_output=True, text=True, timeout=600, env=env,
    )


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    done = _run(REPO, env)
    assert done.returncode != 0
    assert done.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    done = _run(str(tmp_path))
    assert done.returncode != 0
    assert done.stdout.strip() == ""


@pytest.mark.cuda_only
def test_one_short_run_on_a_card(card):
    done = _run(REPO)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = done.stdout.strip().splitlines()
    assert "storage_write_bytes_total" in lines[-2]
    out = json.loads(lines[-1])
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert {"tokens_per_s", "setup_s"} <= set(out["metrics"])
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert done.stderr.strip().splitlines()[-1].startswith("check ")
