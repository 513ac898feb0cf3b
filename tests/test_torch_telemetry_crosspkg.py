"""Telemetry records across the two packages, on the CPU: the same
``state_dict`` saved by a JAX ``CheckpointManager`` (through
``TorchStateful``) and by the port's on the same schedule leaves ledgers
with the same events and byte fields; each package's goodput engine
attributes the other's ledger as its own does; each reads the other's
reports, history rows and heartbeats; the JAX merge takes a port trace
beside a JAX one; and a manager of either package resumes the run id of a
root the other opened.

Timestamps, run ids and seconds differ between two runs and are not
compared; every byte count is compared exactly.
"""

import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import telemetry as jtel
from torchsnapshot_tpu.storage_plugins.fs import FSStoragePlugin as JaxFS
from torchsnapshot_tpu.telemetry import goodput as jgoodput
from torchsnapshot_tpu.telemetry import history as jhistory
from torchsnapshot_tpu.telemetry import ledger as jledger
from torchsnapshot_tpu.telemetry import progress as jprogress
from torchsnapshot_tpu.telemetry import trace as jtrace
from torchsnapshot_tpu.tricks.torch import TorchStateful
from torchsnapshot_tpu_torch import CheckpointManager, PreemptionSaver, Snapshot, TensorTreeState, knobs
from torchsnapshot_tpu_torch import telemetry as ptel
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin as PortFS
from torchsnapshot_tpu_torch.telemetry import goodput as pgoodput
from torchsnapshot_tpu_torch.telemetry import history as phistory
from torchsnapshot_tpu_torch.telemetry import ledger as pledger
from torchsnapshot_tpu_torch.telemetry import progress as pprogress
from torchsnapshot_tpu_torch.telemetry import trace as ptrace

torch.set_num_threads(1)

# Ledger fields that carry bytes or counts (compared exactly); the rest
# are times, ids and kinds.
_BYTE_FIELDS = (
    "bytes_new", "bytes_reused", "bytes_total", "blobs", "nbytes", "bytes_reclaimed",
    "bytes_digest_unchanged", "bytes_digest_covered", "step", "segment", "world_size",
    "target_step",
)


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (jledger, pledger):
        mod.reset_owned_roots()
    for tel in (jtel, ptel):
        tel.reset_metrics()
    yield
    for mod in (jledger, pledger):
        mod.reset_owned_roots()


def _tensors(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal(32).astype(np.float32)),
        "frozen": torch.from_numpy(np.arange(512, dtype=np.float32)),
    }


def _run(pkg: str, root: str) -> None:
    """One schedule: a sync save, an async save recording digests, an
    incremental save with part of the state unchanged, GC of step 0 (keep
    2), a preemption notice and a restore of the latest step."""
    state = _tensors(0)
    if pkg == "jax":
        mgr = jts.CheckpointManager(root, keep_last_n=2)
        wrap = TorchStateful
        saver_cls = jts.preemption.PreemptionSaver
    else:
        mgr = CheckpointManager(root, keep_last_n=2)
        wrap = TensorTreeState
        saver_cls = PreemptionSaver
    mgr.save(0, {"m": wrap(dict(state))})
    mgr.async_save(1, {"m": wrap(dict(state))}, incremental=True).wait()
    state["w"] = state["w"] + 1.0
    mgr.save(2, {"m": wrap(dict(state))}, incremental=True)
    saver = saver_cls(signals=(), ledger_root=root)
    try:
        saver.request_save()
        assert saver.should_save(3)
    finally:
        saver.uninstall()
    dest = {k: torch.zeros_like(v) for k, v in state.items()}
    assert mgr.restore_latest({"m": wrap(dest)}) == 2
    for k, v in state.items():
        assert torch.equal(dest[k], v)


def _shape(records):
    return [
        (r["event"], {k: r[k] for k in _BYTE_FIELDS if k in r}, r.get("kind"), r.get("tier"))
        for r in records
    ]


@pytest.fixture
def ledgers(tmp_path):
    out = {}
    with knobs.enable_ledger(), knobs.override_history_max_records(32):
        for pkg in ("jax", "port"):
            root = str(tmp_path / pkg)
            _run(pkg, root)
            out[pkg] = (root, jledger.load_ledger(os.path.join(root, ".ledger.jsonl")))
    return out


def test_same_schedule_gives_the_same_ledger(ledgers):
    """Same events in the same order with the same byte fields, on both
    packages' managers (a ``TorchStateful`` state dict against the port's
    ``TensorTreeState`` of the same tensors)."""
    (_, jrec), (_, prec) = ledgers["jax"], ledgers["port"]
    assert _shape(prec) == _shape(jrec)
    events = [r["event"] for r in prec]
    assert events[0] == "run-start" and "gc-reclaimed" in events
    assert events.count("step-committed") == 2  # step 0 pruned by GC
    assert {"visible-stall", "staged-drain", "preemption", "restore-served"} <= set(events)
    by_step = {r["step"]: r for r in prec if r["event"] == "step-committed"}
    assert by_step[2]["bytes_reused"] > 0


def test_goodput_analyze_agrees_both_ways(ledgers):
    """The JAX engine's attribution of the port's ledger is the port's,
    and the reverse."""
    for pkg in ("jax", "port"):
        records = ledgers[pkg][1]
        assert jgoodput.analyze(records) == pgoodput.analyze(records)
        assert jgoodput.analyze_root(ledgers[pkg][0]) == pgoodput.analyze_root(ledgers[pkg][0])


def test_history_rows_read_by_the_other_package(ledgers):
    """Each package's ``load_history`` reads the other's rows, and the
    two managers' histories hold the same kinds and byte counts."""
    rows = {}
    for pkg in ("jax", "port"):
        path = os.path.join(ledgers[pkg][0], ".telemetry-history.jsonl")
        rows[pkg] = jhistory.load_history(path)
        assert phistory.load_history(path) == rows[pkg]
    assert [(r["kind"], r["step"], r["bytes_moved"]) for r in rows["port"]] == [
        (r["kind"], r["step"], r["bytes_moved"]) for r in rows["jax"]
    ]


def test_reports_read_by_the_other_package(tmp_path):
    """Each package's ``load_events`` reads the other's report log, and
    the two take reports have the same schema and byte counts."""
    state = _tensors(1)
    with knobs.enable_telemetry():
        jts.Snapshot.take(str(tmp_path / "jax"), {"m": TorchStateful(dict(state))})
        Snapshot.take(str(tmp_path / "port"), {"m": TensorTreeState(dict(state))})
    reports = {}
    for pkg in ("jax", "port"):
        path = str(tmp_path / pkg / ".telemetry.jsonl")
        (reports[pkg],) = jtel.load_events(path)
        assert ptel.load_events(path) == [reports[pkg]]
    assert set(reports["port"]) == set(reports["jax"])
    for f in ("kind", "bytes_moved", "blobs", "schema_version", "rank", "world_size"):
        assert reports["port"][f] == reports["jax"][f], f
    assert set(reports["port"]["phases"]) == set(reports["jax"]["phases"])


def test_terminal_heartbeats_read_by_the_other_package(tmp_path, monkeypatch):
    """A failed take of either package leaves a terminal heartbeat that
    the other package's ``load_progress_file`` reads."""

    async def broken(self, write_io):
        raise OSError("injected")

    for cls in (JaxFS, PortFS):
        monkeypatch.setattr(cls, "write", broken)
        monkeypatch.setattr(cls, "write_with_checksum", broken)
    state = _tensors(2)
    with knobs.override_progress_interval_seconds(0.001):
        with pytest.raises(OSError):
            jts.Snapshot.take(str(tmp_path / "jax"), {"m": TorchStateful(dict(state))})
        with pytest.raises(OSError):
            Snapshot.take(str(tmp_path / "port"), {"m": TensorTreeState(dict(state))})
    docs = {}
    for pkg in ("jax", "port"):
        (path,) = pprogress.find_progress_files(str(tmp_path / pkg))
        assert jprogress.find_progress_files(str(tmp_path / pkg)) == [path]
        docs[pkg] = jprogress.load_progress_file(path)
        assert pprogress.load_progress_file(path) == docs[pkg]
    assert set(docs["port"]) == set(docs["jax"])
    for f in ("kind", "terminal", "planned_bytes", "planned_items", "schema_version"):
        assert docs["port"][f] == docs["jax"][f], f


def test_jax_merge_takes_a_port_trace_beside_a_jax_one(tmp_path):
    """The JAX ``merge_traces`` merges a port take's trace with a JAX
    take's (one pid each, B/E balanced), and the port's merge gives the
    same document."""
    state = _tensors(3)
    with knobs.enable_trace():
        jts.Snapshot.take(str(tmp_path / "jax"), {"m": TorchStateful(dict(state))})
        Snapshot.take(str(tmp_path / "port"), {"m": TensorTreeState(dict(state))})
    files = [
        str(tmp_path / "jax" / ".trace-take-rank0.json"),
        str(tmp_path / "port" / ".trace-take-rank0.json"),
    ]
    merged = jtrace.merge_traces(files)
    pids = {e["pid"] for e in merged["traceEvents"] if e["ph"] != "M"}
    assert pids == {0, 1}
    spans = jtrace.spans_from_chrome(merged)
    assert {s["pid"] for s in spans if s["name"] == "snapshot:take"} == {0, 1}
    again = ptrace.merge_traces(files)
    assert again["traceEvents"] == merged["traceEvents"]


@pytest.mark.parametrize("first", ["jax", "port"])
def test_manager_resumes_the_other_packages_run_id(tmp_path, first):
    """A manager that extends a root the other package's manager opened
    resumes its run id with the next segment."""
    root = str(tmp_path / "root")
    state = _tensors(4)
    with knobs.enable_ledger():
        if first == "jax":
            a = jts.CheckpointManager(root)
            a.save(0, {"m": TorchStateful(dict(state))})
            b = CheckpointManager(root)
            b.save(1, {"m": TensorTreeState(dict(state))})
        else:
            a = CheckpointManager(root)
            a.save(0, {"m": TensorTreeState(dict(state))})
            b = jts.CheckpointManager(root)
            b.save(1, {"m": TorchStateful(dict(state))})
        assert a._ledger_run_id is not None and b._ledger_run_id == a._ledger_run_id
        records = pledger.load_ledger(os.path.join(root, ".ledger.jsonl"))
    starts = [r for r in records if r["event"] == "run-start"]
    assert [s["segment"] for s in starts] == [1, 2]
    assert [r["step"] for r in records if r["event"] == "step-committed"] == [0, 1]
