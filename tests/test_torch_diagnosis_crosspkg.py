"""Diagnosis and control across the two packages, on the CPU: the same
recorder events give the same critical path; each package's doctor, SLO
engine and bundle reader read a manager root the other wrote and give
what the writer's own give; the same report sequence gives the same tuner
decisions, and each tuner resumes from the other's ``.tuner-state.json``;
both watchdogs fire once per hang and re-arm on one span pattern.

Timestamps and seconds differ between two runs and are compared only
where both sides read the same file.
"""

import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu import telemetry as jtel
from torchsnapshot_tpu.telemetry import bundle as jbundle
from torchsnapshot_tpu.telemetry import critpath as jcritpath
from torchsnapshot_tpu.telemetry import doctor as jdoctor
from torchsnapshot_tpu.telemetry import ledger as jledger
from torchsnapshot_tpu.telemetry import slo as jslo
from torchsnapshot_tpu.telemetry import trace as jtrace
from torchsnapshot_tpu.telemetry import watchdog as jwatchdog
from torchsnapshot_tpu.tuner import Autotuner as JaxAutotuner
from torchsnapshot_tpu.tuner import state as jtuner_state
from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict, knobs
from torchsnapshot_tpu_torch import telemetry as ptel
from torchsnapshot_tpu_torch.telemetry import bundle as pbundle
from torchsnapshot_tpu_torch.telemetry import critpath as pcritpath
from torchsnapshot_tpu_torch.telemetry import doctor as pdoctor
from torchsnapshot_tpu_torch.telemetry import ledger as pledger
from torchsnapshot_tpu_torch.telemetry import names
from torchsnapshot_tpu_torch.telemetry import slo as pslo
from torchsnapshot_tpu_torch.telemetry import trace as ptrace
from torchsnapshot_tpu_torch.telemetry import watchdog as pwatchdog
from torchsnapshot_tpu_torch.tuner import Autotuner as PortAutotuner
from torchsnapshot_tpu_torch.tuner import state as ptuner_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    def reset():
        for tel in (jtel, ptel):
            tel.reset_metrics()
            tel.reset_trace()
        for mod in (jledger, pledger):
            mod.reset_owned_roots()
        for mod in (jslo, pslo):
            mod.reset_slo_state()
        for mod in (jbundle, pbundle):
            mod.reset_bundle_state()
        for mod in (jwatchdog, pwatchdog):
            mod.reset_watchdog()
        jknobs.clear_tuner_overrides()
        knobs.clear_tuner_overrides()

    reset()
    yield
    reset()


def _arrays(seed, n=2, size=256):
    rng = np.random.default_rng(seed)
    return {f"l{i}": rng.standard_normal(size).astype(np.float32) for i in range(n)}


def _save(pkg, mgr, step):
    arrays = _arrays(step)
    if pkg == "jax":
        mgr.save(step, {"s": jts.PyTreeState(arrays)})
    else:
        mgr.save(step, {"s": StateDict({k: torch.from_numpy(v) for k, v in arrays.items()})})


def _manager(pkg, root):
    return (jts.CheckpointManager if pkg == "jax" else CheckpointManager)(root, keep_last_n=4)


# ---------------------------------------------------------------------------
# Critical paths
# ---------------------------------------------------------------------------


def _ev(name, ts_us, dur_us, bseq, args=None):
    return {"ph": "X", "name": name, "ts": ts_us, "dur": dur_us, "bseq": bseq, "args": args or {}}


@pytest.mark.parametrize(
    "kind, events",
    [
        ("take", [
            _ev(names.SPAN_TAKE, 0, 1_000_000, 0),
            _ev(names.SPAN_PIPELINE_STAGE, 0, 400_000, 1),
            _ev(names.SPAN_STORAGE_WRITE, 100_000, 200_000, 2, {"blob": "0/w"}),
            _ev(names.SPAN_BARRIER_ARRIVE, 500_000, 300_000, 3),
        ]),
        ("async_take", [
            _ev(names.SPAN_ASYNC_TAKE_STAGE, 0, 100_000, 0),
            _ev(names.SPAN_ASYNC_TAKE_COMMIT, 200_000, 300_000, 1),
            _ev(names.SPAN_DEVICE_CAPTURE, 0, 100_000, 2),
            _ev(names.SPAN_STORAGE_WRITE, 150_000, 100_000, 3),
        ]),
        ("restore", [
            _ev(names.SPAN_RESTORE, 0, 50_000, 0),
            _ev(names.SPAN_PEER_PULL, 1_000, 20_000, 1, {"blob": "0/m/w"}),
            _ev(names.SPAN_STORAGE_READ, 25_000, 10_000, 2),
            _ev(names.SPAN_FANOUT_EXCHANGE, 30_000, 15_000, 3),
        ]),
        ("mirror", [_ev(names.SPAN_MIRROR_JOB, 0, 10_000, 0), _ev(names.SPAN_MIRROR_BLOB, 0, 8_000, 1)]),
    ],
    ids=["take", "async_take", "restore", "mirror"],
)
def test_same_events_give_the_same_critical_path(kind, events):
    ours = pcritpath.critical_path_from_events(events, kind)
    assert ours is not None and ours == jcritpath.critical_path_from_events(events, kind)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_recorded_take_window_attributes_alike(tmp_path, pkg):
    """A real take's recorder window, from either package's recorder, is
    attributed alike by both engines, and matches the writer's report."""
    path = str(tmp_path / "snap")
    arrays = _arrays(0, n=3, size=1 << 16)
    if pkg == "jax":
        rec = jtrace.get_recorder()
        mark = rec.mark()
        jts.Snapshot.take(path, {"s": jts.PyTreeState(arrays)})
        report = jtel.last_report("take")
    else:
        rec = ptrace.get_recorder()
        mark = rec.mark()
        Snapshot.take(path, {"s": StateDict({k: torch.from_numpy(v) for k, v in arrays.items()})})
        report = ptel.last_report("take")
    events = rec.events_since(mark)
    ours = pcritpath.critical_path_from_events(events, "take")
    assert ours == jcritpath.critical_path_from_events(events, "take") == report.critical_path
    assert ours["coverage"] >= pcritpath.MIN_COVERAGE


# ---------------------------------------------------------------------------
# One root, both readers: doctor, SLO engine, bundles
# ---------------------------------------------------------------------------


def _breaching_root(pkg, root):
    """A managed run of ``pkg`` whose every take breaches the visible
    budget: one slo-breach event and one bundle at the root."""
    with knobs.enable_ledger(), knobs.enable_telemetry(), knobs.enable_slo(), (
        knobs.override_bundle_max_bytes(1 << 20)
    ), knobs.override_bundle_min_interval_seconds(0.0), knobs.override_history_max_records(16), (
        knobs.override_async_visible_budget_seconds(0.0001)
    ), knobs.override_slo_overhead_fraction(0):
        mgr = _manager(pkg, root)
        for step in range(3):
            _save(pkg, mgr, step)
    return mgr


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_both_doctors_slo_engines_and_bundle_readers_agree_on_a_root(tmp_path, writer):
    root = str(tmp_path / writer)
    mgr = _breaching_root(writer, root)
    step_path = mgr.step_path(2)
    breaches = [r for r in pledger.load_ledger(pledger.ledger_path_for(root)) if r["event"] == names.EVENT_SLO_BREACH]
    assert [r["objective"] for r in breaches] == [names.SLO_TAKE_VISIBLE_STALL]
    with knobs.override_async_visible_budget_seconds(0.0001), knobs.override_slo_overhead_fraction(0):
        ours = [v.to_dict() for v in pdoctor.diagnose_snapshot(step_path)]
        assert ours == [v.to_dict() for v in jdoctor.diagnose_snapshot(step_path)]
        assert names.RULE_SLO_BURNING in {v["rule"] for v in ours}
        pres, jres = pslo.evaluate_root(root), jslo.evaluate_root(root)
        assert pres == jres and pres["breaching"] == [names.SLO_TAKE_VISIBLE_STALL]
    plist, jlist = pbundle.list_bundles(root), jbundle.list_bundles(root)
    assert plist == jlist and [b["trigger"] for b in plist] == ["slo-breach"]
    path = plist[0]["path"]
    manifest = pbundle.load_manifest(path)
    assert manifest == jbundle.load_manifest(path)
    assert names.SLO_TAKE_VISIBLE_STALL in manifest["reason"]
    assert {f["name"] for f in manifest["files"]} >= {".ledger.jsonl", ".telemetry.jsonl"}
    # The bundle diagnoses alike with either package's doctor.
    with knobs.override_async_visible_budget_seconds(0.0001), knobs.override_slo_overhead_fraction(0):
        assert [v.to_dict() for v in pdoctor.diagnose_snapshot(path)] == [
            v.to_dict() for v in jdoctor.diagnose_snapshot(path)
        ]


def test_manifests_of_both_packages_share_one_schema(tmp_path):
    with knobs.enable_ledger(), knobs.override_bundle_max_bytes(1 << 20):
        for pkg, mod, led in (("port", pbundle, pledger), ("jax", jbundle, jledger)):
            root = str(tmp_path / pkg)
            assert led.open_run(root) is not None
            path = mod.capture_bundle(root, trigger="manual", reason="schema")
            manifest = pbundle.load_manifest(path)
            assert manifest == jbundle.load_manifest(path)
            keys = set(manifest)
            if pkg == "port":
                port_keys = keys
    assert keys == port_keys


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------


def _fake_report(take_s, budget_wait_s=0.0, staging=0.4):
    return {
        "kind": "take", "rank": 0, "phases": {"staging": round(take_s * staging, 3), "writing": take_s},
        "bytes_moved": 128 * 1024 * 1024, "budget_wait_s": budget_wait_s, "retries": {}, "mirror": {},
    }


# take_s, budget_wait_s, staging share: explore, explore, a regression
# (revert), budget-starved, storage-tier-slow, d2h-bound, explore.
_SEQUENCE = [
    (1.0, 0.0, 0.4), (1.0, 0.0, 0.4), (1.0, 0.0, 0.4), (3.0, 0.0, 0.4), (1.0, 0.6, 0.4),
    (1.0, 0.0, 0.05), (1.0, 0.0, 0.95), (1.0, 0.0, 0.4),
]


def _decisions(tuner_cls, root, pin_io=False):
    at = tuner_cls(root)
    ctx = knobs.override_per_rank_io_concurrency(16) if pin_io else _nullctx()
    with ctx:
        vectors = [at._decide(step, _fake_report(*args)) for step, args in enumerate(_SEQUENCE)]
    return vectors


class _nullctx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _strip(record):
    return {k: v for k, v in record.items() if k != "unix_ts"}


@pytest.mark.parametrize("pin_io", [False, True], ids=["free", "io-pinned"])
def test_same_reports_give_the_same_tuner_decisions(tmp_path, monkeypatch, pin_io):
    """With ``io_concurrency`` pinned, ``storage-tier-slow`` reaches past
    it: ``write_vectorized`` sits at its upper bound in both tuners, so
    both move ``fs_direct_io`` (unpinned here: the suite pins it)."""
    monkeypatch.delenv("TORCHSNAPSHOT_TPU_FS_DIRECT_IO", raising=False)
    pvec = _decisions(PortAutotuner, str(tmp_path / "port"), pin_io)
    jvec = _decisions(JaxAutotuner, str(tmp_path / "jax"), pin_io)
    assert jvec == pvec
    assert all(j["write_vectorized"] == 1 for j in jvec)
    pst = ptuner_state.load_state(str(tmp_path / "port"))
    jst = jtuner_state.load_state(str(tmp_path / "jax"))
    assert [_strip(d) for d in pst.decisions] == [_strip(d) for d in jst.decisions]
    actions = [d["decision"]["action"] for d in pst.decisions]
    assert "revert" in actions and "adjust" in actions and "hold" in actions
    if pin_io:
        assert any(d["decision"]["tunable"] == "fs_direct_io" for d in pst.decisions)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_tuner_resumes_from_the_others_state_file(tmp_path, writer):
    root = str(tmp_path)
    first, second = (JaxAutotuner, PortAutotuner) if writer == "jax" else (PortAutotuner, JaxAutotuner)
    first_state = (jtuner_state if writer == "jax" else ptuner_state)
    for step in range(2):
        first(root)._decide(step, _fake_report(1.0))
    written = first_state.load_state(root)
    reader = ptuner_state if writer == "jax" else jtuner_state
    loaded = reader.load_state(root)
    assert loaded.to_dict() == written.to_dict()
    vec = second(root)._decide(2, _fake_report(1.0))
    resumed = reader.load_state(root)
    assert [d["step"] for d in resumed.decisions] == [0, 1, 2]
    assert resumed.decision_count == 3
    last = written.decisions[-1]["decision"]
    assert vec[last["tunable"]] == last["to_value"]
    assert resumed.vector["write_vectorized"] == written.vector["write_vectorized"] == 1


# ---------------------------------------------------------------------------
# Watchdogs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_watchdog_fires_once_per_hang_and_rearms(pkg):
    rec, tel = (ptrace.get_recorder(), ptel) if pkg == "port" else (jtrace.get_recorder(), jtel)
    registry = tel.metrics()
    baseline = registry.counters_snapshot()
    with knobs.override_watchdog_deadline_seconds(0.1):
        with rec.span(names.SPAN_STORAGE_WRITE, blob="a"):
            time.sleep(0.35)  # one hang, several scans: one firing
        time.sleep(0.2)
        with rec.span(names.SPAN_STORAGE_WRITE, blob="b"):
            time.sleep(0.35)
        time.sleep(0.1)
    assert registry.counters_delta_since(baseline).get(names.WATCHDOG_STALLS_TOTAL) == 2.0
    stalls = [e for e in rec.events_since(0) if e["name"] == names.INSTANT_WATCHDOG_STALL]
    assert [s["args"]["gating_segment"] for s in stalls] == ["write_drain", "write_drain"]
