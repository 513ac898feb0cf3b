"""Discovery: a cell of ``BENCHMARK.json`` and the files it names.

A configuration is ``configs/<name>.json`` (its ``file`` in
``BENCHMARK.json``), its architecture's adapter ``archs/<name>.py`` and
plain reference ``reference/<name>.py`` (``harness/arch.py``), a traffic
mix is ``traffic/<name>.json``, a per-layer metric is
``metrics/<name>.py``. Adding any of them is adding files and entries;
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from types import ModuleType
from typing import Any, Callable, Dict, List, Mapping, Optional

from . import arch as arch_spec
from .data import make_weights

LOOP_KINDS = ("save", "restart")


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    moves: Optional[str] = None
    workloads: Optional[List[str]] = None
    reader: Optional[Callable[[Dict[str, Any]], Optional[float]]] = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    arch: ModuleType
    reference: ModuleType
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)

    @property
    def dims(self) -> Any:
        return self.arch.dims(self.config)

    @property
    def leaves(self) -> Mapping[str, arch_spec.Leaf]:
        return self.arch.leaf_shapes(self.dims)

    def weights(self, seed: int, device: Any) -> Dict[str, Any]:
        """The parameters drawn from ``seed``, for the program and the reference alike."""
        return make_weights(self.leaves, self.dims.dtype, seed, device)

    @property
    def ranks(self) -> int:
        return int(self.traffic.get("ranks", 1))


def load_module(path: str, prefix: str) -> ModuleType:
    """The Python file at ``path`` as a module of its own."""
    name = prefix + os.path.basename(path)[:-3].replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # a dataclass looks its module up while it is made
    spec.loader.exec_module(module)
    return module


def load_arch(home: str, config: Mapping[str, Any]) -> ModuleType:
    """The adapter of ``config``'s architecture, ``<home>/archs/<name>.py``."""
    name = config.get("architecture", arch_spec.DEFAULT)
    module = load_module(os.path.join(home, "archs", f"{name}.py"), "portbench_arch_")
    missing = [n for n in arch_spec.REQUIRED if not hasattr(module, n)]
    if missing:
        raise ValueError(f"architecture {name!r} lacks {missing} (harness/arch.py)")
    return module


def load_reader(path: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    """``read(record)`` of a metric file: a number, or None when the run
    holds nothing for the metric to read."""
    return load_module(path, "portbench_metric_").read


def _metric(entry: Dict[str, Any]) -> Metric:
    return Metric(
        name=entry["name"], unit=entry["unit"], better=entry["better"], source=entry["source"],
        moves=entry.get("moves"), workloads=entry.get("workloads"),
    )


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its configuration,
    its traffic mix and the metrics it reports, each per-layer metric with
    its reader from ``<root>/<paths[0]>/metrics/<metric>.py``, its
    architecture's adapter and reference from ``archs/`` and ``reference/``
    there."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    home = os.path.join(root, bench["paths"][0])
    with open(os.path.join(home, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    if traffic.get("loop") not in LOOP_KINDS:
        raise ValueError(f"traffic {w['traffic']!r}: loop must be one of {LOOP_KINDS}")
    adapter = load_arch(home, config)
    cell = Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=traffic, arch=adapter,
        reference=load_module(os.path.join(home, "reference", f"{adapter.reference}.py"), "portbench_reference_"),
    )
    if cell.ranks not in (1, cell.chips):
        raise ValueError(f"cell {name!r}: traffic asks for {cell.ranks} ranks on {cell.chips} chips")
    cell.end_to_end = [m for m in map(_metric, bench["end_to_end"]) if m.applies_to(name)]
    for entry in bench["per_layer"]:
        m = _metric(entry)
        if m.applies_to(name):
            m.reader = load_reader(os.path.join(home, "metrics", f"{m.name}.py"))
            cell.per_layer.append(m)
    return cell
