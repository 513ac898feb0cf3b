"""The port's incident bundles: bounded capture, rate limiting, the
snapshot-dir-shaped layout, one bundle per watchdog stall episode, and
the injected SLO breach on a real manager run: one breach event, one
bundle, and a relocated copy of that bundle reproduces the live doctor
verdicts with the original root deleted.

Ports of the JAX package's ``tests/test_bundle.py``, under the same
names, on torch state. This file imports no ``jax``: each package reading
the other's bundle is in ``tests/test_torch_diagnosis_crosspkg.py``.
"""

import asyncio
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict, knobs, telemetry
from torchsnapshot_tpu_torch.telemetry import bundle, doctor, ledger, names, slo
from torchsnapshot_tpu_torch.telemetry.watchdog import reset_watchdog

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_state():
    def reset():
        reset_watchdog()
        telemetry.reset_metrics()
        telemetry.reset_trace()
        ledger.reset_owned_roots()
        slo.reset_slo_state()
        bundle.reset_bundle_state()

    reset()
    yield
    reset()


def _state(n=2, size=256, seed=0):
    rng = np.random.default_rng(seed)
    return {"s": StateDict({f"l{i}": torch.from_numpy(rng.standard_normal(size).astype(np.float32)) for i in range(n)})}


def _run_manager(root, steps=(0, 1)):
    mgr = CheckpointManager(root, keep_last_n=4)
    for step in steps:
        mgr.save(step, _state(seed=step))
    return mgr


def test_capture_assembles_bounded_snapshot_shaped_dir(tmp_path):
    root = str(tmp_path)
    with knobs.enable_ledger(), knobs.enable_telemetry():
        _run_manager(root)
        with knobs.override_bundle_max_bytes(1 << 20):
            path = bundle.capture_bundle(root, trigger="manual", reason="unit test", step=1)
    assert path is not None and bundle.is_bundle(path)
    assert os.path.dirname(path) == os.path.join(root, ".bundles")
    manifest = bundle.load_manifest(path)
    assert manifest["trigger"] == "manual"
    assert manifest["reason"] == "unit test"
    assert manifest["step"] == 1
    assert manifest["root"] == root
    assert manifest["bytes"] <= manifest["max_bytes"]
    copied = {f["name"] for f in manifest["files"]}
    assert ".ledger.jsonl" in copied and ".telemetry.jsonl" in copied
    assert any(k.startswith("TORCHSNAPSHOT_TPU_") for k in manifest["knobs"])
    assert manifest["env"]["pid"] == os.getpid()
    assert manifest["tunables"] == knobs.tunable_snapshot()
    assert isinstance(manifest["verdicts"], list)
    assert ledger.find_ledger_for(path) == os.path.join(path, ".ledger.jsonl")
    assert [b["path"] for b in bundle.list_bundles(root)] == [path]


def test_capture_disabled_and_rate_limited(tmp_path):
    root = str(tmp_path)
    with knobs.enable_ledger():
        assert ledger.open_run(root) is not None
        # The suite's conftest pins max bytes to 0: capture is off.
        assert bundle.capture_bundle(root, trigger="manual") is None
        with knobs.override_bundle_max_bytes(1 << 20):
            assert bundle.capture_bundle(root, trigger="manual") is not None
            assert bundle.capture_bundle(root, trigger="manual") is None
            with knobs.override_bundle_min_interval_seconds(0.0):
                assert bundle.capture_bundle(root, trigger="manual")


def test_tiny_budget_keeps_the_newest_ledger_tail(tmp_path):
    root = str(tmp_path)
    with knobs.enable_ledger():
        assert ledger.open_run(root) is not None
        for i in range(200):
            ledger.post_event(root, names.EVENT_STEP_COMMITTED, step=i, bytes_new=1)
        with knobs.override_bundle_max_bytes(2048):
            path = bundle.capture_bundle(root, trigger="manual")
    assert path is not None
    manifest = bundle.load_manifest(path)
    entry = next(f for f in manifest["files"] if f["name"] == ".ledger.jsonl")
    assert entry["truncated"]
    assert manifest["bytes"] <= 2048
    assert ledger.load_ledger(os.path.join(path, ".ledger.jsonl"))[-1]["step"] == 199


def test_step_dir_root_lands_at_the_manager_root(tmp_path):
    root = str(tmp_path)
    with knobs.enable_ledger(), knobs.enable_telemetry():
        _run_manager(root, steps=(3,))
        with knobs.override_bundle_max_bytes(1 << 20):
            path = bundle.capture_bundle(os.path.join(root, "step_3"), trigger="failed-op")
    assert path is not None
    assert os.path.dirname(path) == os.path.join(root, ".bundles")
    manifest = bundle.load_manifest(path)
    assert manifest["root"] == root
    assert manifest["snapshot_path"] == os.path.join(root, "step_3")


def test_watchdog_stall_captures_exactly_one_bundle(tmp_path, monkeypatch, caplog):
    """A stall of one storage write of the port's take: exactly one
    bundle, named by both the log line and the ``watchdog:stall``
    instant."""
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    orig_write = FSStoragePlugin.write
    injected = []

    async def slow_write(self, write_io):
        if not injected:
            injected.append(write_io.path)
            await asyncio.sleep(0.7)
        await orig_write(self, write_io)

    monkeypatch.setattr(FSStoragePlugin, "write", slow_write)
    root = str(tmp_path)
    snap = os.path.join(root, "snap")
    with knobs.enable_ledger(), knobs.override_bundle_max_bytes(1 << 20), (
        knobs.override_bundle_min_interval_seconds(0.0)
    ):
        assert ledger.open_run(root) is not None
        with knobs.override_watchdog_deadline_seconds(0.15), knobs.enable_trace():
            with caplog.at_level("ERROR"):
                Snapshot.take(snap, _state(n=1, size=64))
        time.sleep(0.3)  # further scans must not capture again
    bundles = bundle.list_bundles(root)
    assert len(bundles) == 1
    assert bundles[0]["trigger"] == "watchdog-stall"
    assert "span" in str(bundle.load_manifest(bundles[0]["path"])["reason"])
    assert any(bundles[0]["path"] in r.message for r in caplog.records if "incident bundle" in r.message)
    with open(os.path.join(snap, ".trace-take-rank0.json")) as f:
        doc = json.load(f)
    stalls = [e for e in doc["traceEvents"] if e["ph"] == "i" and e["name"] == names.INSTANT_WATCHDOG_STALL]
    assert len(stalls) == 1
    assert stalls[0]["args"]["bundle"] == bundles[0]["path"]


def _breach_overrides():
    """An impossible visible budget makes every take a bad sample; the
    overhead objective is off, so that exactly one objective breaches."""
    return knobs.override_async_visible_budget_seconds(0.0001), knobs.override_slo_overhead_fraction(0)


def test_injected_breach_posts_one_event_and_one_bundle(tmp_path):
    root = str(tmp_path)
    o1, o2 = _breach_overrides()
    with knobs.enable_ledger(), knobs.enable_telemetry(), knobs.enable_slo(), (
        knobs.override_bundle_max_bytes(1 << 20)
    ), knobs.override_bundle_min_interval_seconds(0.0), o1, o2:
        _run_manager(root, steps=(0, 1, 2))
    breaches = [r for r in ledger.load_ledger(ledger.ledger_path_for(root)) if r.get("event") == names.EVENT_SLO_BREACH]
    assert len(breaches) == 1
    assert breaches[0]["objective"] == names.SLO_TAKE_VISIBLE_STALL
    bundles = bundle.list_bundles(root)
    assert len(bundles) == 1
    assert bundles[0]["trigger"] == "slo-breach"
    assert names.SLO_TAKE_VISIBLE_STALL in bundle.load_manifest(bundles[0]["path"])["reason"]
    bundled = ledger.load_ledger(os.path.join(bundles[0]["path"], ".ledger.jsonl"))
    assert any(r.get("event") == names.EVENT_SLO_BREACH for r in bundled)


def test_relocated_bundle_reproduces_doctor_verdicts_offline(tmp_path, capsys):
    root = str(tmp_path / "run")
    os.makedirs(root)
    o1, o2 = _breach_overrides()
    with knobs.enable_ledger(), knobs.enable_telemetry(), knobs.enable_slo(), (
        knobs.override_bundle_max_bytes(1 << 20)
    ), knobs.override_bundle_min_interval_seconds(0.0), o1, o2:
        _run_manager(root, steps=(0, 1))
        bundles = bundle.list_bundles(root)
        assert len(bundles) == 1
        live_ids = sorted({v["rule"] for v in bundle.load_manifest(bundles[0]["path"])["verdicts"]})
        assert names.RULE_SLO_BURNING in live_ids
        relocated = str(tmp_path / "evidence" / "incident")
        shutil.copytree(bundles[0]["path"], relocated)
        shutil.rmtree(root)
        assert slo.main([relocated]) == 2
        capsys.readouterr()
        rc = doctor.main(["--bundle", relocated, "--json"])
        assert rc == 2
        assert sorted({v["rule"] for v in json.loads(capsys.readouterr().out)}) == live_ids
    assert doctor.main(["--bundle", str(tmp_path)]) == 1
    assert "not an incident bundle" in capsys.readouterr().out
