"""A copy of the benchmark at a size the CPU tests can hold: every
configuration cut by its own architecture's ``tiny`` (``archs/dense.py``:
two blocks of width 64, a vocabulary of 512 and two sequences of 128
tokens); the traffic mixes, metric readers, adapters and references as
they are."""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

from harness.spec import load_arch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
COPIED = ("traffic", "metrics", "archs", "reference")


def make_tiny_root(dest: str, limits: Optional[dict] = None) -> str:
    """``dest`` holding ``BENCHMARK.json`` and ``portbench/`` with tiny
    configurations, held to their own limits unless ``limits`` is given;
    returns ``dest``."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    home = os.path.join(dest, bench["paths"][0])
    for sub in COPIED:
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(home, sub), dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(home, "configs"), exist_ok=True)
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        cfg = load_arch(BENCH, cfg).tiny(cfg)
        if limits is not None:
            cfg["limits"] = dict(limits)
        with open(os.path.join(dest, c["file"]), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest
