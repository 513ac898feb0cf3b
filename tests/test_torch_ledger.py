"""The port's run ledger: crash-safe appends, run-id resume, the bound,
GC pruning, the manager's, mirror's and preemption saver's posts, and
rank-0-only appends across two processes.

Ports of the JAX package's ``tests/test_ledger.py``, all ten cases, and of
``tests/test_cas.py``'s ledger accounting case (each
docstring names the case it ports), on torch state. This file imports no
``jax``, so its two-rank worker runs in spawned processes; the
cross-package cases are in ``tests/test_torch_telemetry_crosspkg.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, StateDict, TensorTreeState, knobs, telemetry
from torchsnapshot_tpu_torch.telemetry import goodput, ledger, names

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset_metrics()
    ledger.reset_owned_roots()
    yield
    telemetry.reset_metrics()
    ledger.reset_owned_roots()


def _state(n=2, size=1024, seed=0):
    rng = np.random.default_rng(seed)
    return {f"l{i}": torch.from_numpy(rng.standard_normal(size).astype(np.float32)) for i in range(n)}


def _events(records, event):
    return [r for r in records if r["event"] == event]


def test_disabled_ledger_writes_nothing(tmp_path):
    """Ports ``test_disabled_ledger_writes_nothing``: under the conftest's
    ``TORCHSNAPSHOT_TPU_LEDGER=0`` no file appears."""
    root = str(tmp_path / "off")
    mgr = CheckpointManager(root)
    mgr.save(0, {"s": TensorTreeState(_state())})
    assert not os.path.exists(os.path.join(root, ledger.LEDGER_BASENAME))
    assert ledger.find_ledger_for(root) is None


def test_post_event_without_open_run_creates_no_orphan(tmp_path):
    """Ports ``test_post_event_without_open_run_creates_no_orphan``."""
    with knobs.enable_ledger():
        assert ledger.post_event(str(tmp_path), names.EVENT_STEP_COMMITTED) is None
        assert list(tmp_path.iterdir()) == []


def test_torn_final_line_is_skipped_and_run_id_resumes(tmp_path):
    """Ports ``test_torn_final_line_is_skipped_and_run_id_resumes``: a
    torn tail is skipped and a reopened run keeps its id, next segment."""
    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        rid = ledger.open_run(root, world_size=1)
        assert rid is not None
        ledger.post_event(
            root, names.EVENT_STEP_COMMITTED, step=0, bytes_new=10, bytes_reused=0,
            bytes_total=10, blobs=1,
        )
        path = ledger.ledger_path_for(root)
        with open(path, "a", encoding="utf-8") as f:
            f.write('{"event": "step-com')
        records = ledger.load_ledger(path)
        assert [r["event"] for r in records] == [names.EVENT_RUN_START, names.EVENT_STEP_COMMITTED]
        assert ledger.open_run(root, world_size=1) == rid
        starts = _events(ledger.load_ledger(path), names.EVENT_RUN_START)
        assert [s["segment"] for s in starts] == [1, 2]
        assert {s["run_id"] for s in starts} == {rid}


def test_manager_restart_resumes_run_id(tmp_path):
    """Ports ``test_manager_restart_resumes_run_id``."""
    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        mgr = CheckpointManager(root)
        mgr.save(0, {"s": TensorTreeState(_state())})
        first = mgr._ledger_run_id
        assert first is not None
        assert CheckpointManager(root)._ledger_run_id == first
        records = ledger.load_ledger(ledger.ledger_path_for(root))
        assert [r["segment"] for r in _events(records, names.EVENT_RUN_START)] == [1, 2]


def test_bound_trims_oldest_but_keeps_newest_run_start(tmp_path):
    """Ports ``test_bound_trims_oldest_but_keeps_newest_run_start``."""
    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger(), knobs.override_ledger_max_records(10):
        ledger.open_run(root)
        path = ledger.ledger_path_for(root)
        for i in range(ledger.TRIM_CHECK_EVERY * 2 + 5):
            ledger.post_event(
                root, names.EVENT_VISIBLE_STALL, step=i, visible_s=0.01, wall_s=0.01, nbytes=1
            )
        records = ledger.load_ledger(path)
        assert len(records) <= 10 + ledger.TRIM_CHECK_EVERY
        assert _events(records, names.EVENT_RUN_START)
        steps = [r["step"] for r in _events(records, names.EVENT_VISIBLE_STALL)]
        assert steps == sorted(steps)
        assert steps[-1] == ledger.TRIM_CHECK_EVERY * 2 + 4


def test_gc_prunes_step_committed_records(tmp_path):
    """Ports ``test_gc_prunes_step_committed_records``: GC drops the
    deleted steps' step-committed records and posts gc-reclaimed; their
    visible stalls stay."""
    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        mgr = CheckpointManager(root, keep_last_n=2)
        for step in range(4):
            mgr.save(step, {"s": TensorTreeState(_state(seed=step))})
        records = ledger.load_ledger(ledger.ledger_path_for(root))
        assert [r["step"] for r in _events(records, names.EVENT_STEP_COMMITTED)] == [2, 3]
        reclaimed = _events(records, names.EVENT_GC_RECLAIMED)
        assert [r["step"] for r in reclaimed] == [0, 1]
        assert all(r["bytes_reclaimed"] > 0 for r in reclaimed)
        assert [r["step"] for r in _events(records, names.EVENT_VISIBLE_STALL)] == [0, 1, 2, 3]


def test_incremental_saves_record_reuse_bytes(tmp_path):
    """Ports ``test_incremental_saves_record_reuse_bytes``: an unchanged
    incremental step records its bytes as reused."""
    root = str(tmp_path / "ckpts")
    state = _state(n=4, size=4096)
    with knobs.enable_ledger():
        mgr = CheckpointManager(root, incremental=True)
        mgr.save(0, {"s": TensorTreeState(state)})
        mgr.save(1, {"s": TensorTreeState(state)})
        records = ledger.load_ledger(ledger.ledger_path_for(root))
        by_step = {r["step"]: r for r in _events(records, names.EVENT_STEP_COMMITTED)}
        assert by_step[0]["bytes_reused"] == 0
        assert by_step[0]["bytes_new"] > 0
        assert by_step[1]["bytes_reused"] > 0
        # Digests cover the state and say all of step 1 was unchanged.
        assert by_step[1]["bytes_digest_unchanged"] == by_step[1]["bytes_digest_covered"] > 0
        assert goodput.analyze(records)["storage"]["incremental_reuse_ratio"] > 0.3


def test_tiered_save_posts_mirror_settled(tmp_path):
    """Ports ``test_tiered_save_posts_mirror_settled``: the background
    mirror posts its settle event to the manager root's ledger."""
    from torchsnapshot_tpu_torch.tiered import reset_mirror

    root = f"tiered://{tmp_path / 'fast'}|{tmp_path / 'durable'}"
    reset_mirror()
    try:
        with knobs.enable_ledger():
            mgr = CheckpointManager(root)
            mgr.save(0, {"s": TensorTreeState(_state())})
            mgr.wait_durable(0, timeout=60.0)
            settled = _events(
                ledger.load_ledger(ledger.ledger_path_for(root)), names.EVENT_MIRROR_SETTLED
            )
            assert settled and settled[0]["step"] == 0
            assert settled[0]["nbytes"] > 0
            assert settled[0]["error"] is None
    finally:
        reset_mirror()


def test_preemption_saver_posts_agreement(tmp_path):
    """Ports ``test_preemption_saver_posts_agreement``: a one-process
    notice records the step and the target."""
    from torchsnapshot_tpu_torch import PreemptionSaver

    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        mgr = CheckpointManager(root)
        mgr.save(0, {"s": TensorTreeState(_state())})
        saver = PreemptionSaver(signals=(), ledger_root=root)
        try:
            saver.request_save()
            assert saver.should_save(3)
        finally:
            saver.uninstall()
        preempts = _events(ledger.load_ledger(ledger.ledger_path_for(root)), names.EVENT_PREEMPTION)
        assert len(preempts) == 1
        assert preempts[0]["step"] == 3
        assert preempts[0]["target_step"] == 3


def _two_rank_ledger_worker(pg, root: str):
    os.environ["TORCHSNAPSHOT_TPU_LEDGER"] = "1"
    os.environ["TORCHSNAPSHOT_TPU_PEER_TIER"] = "0"
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    PGWrapper(pg).barrier()
    mgr = CheckpointManager(root, pg=pg)
    for step in range(2):
        mgr.save(step, {"s": TensorTreeState(_state(seed=step)), "r": StateDict(rank=pg.rank)})
    PGWrapper(pg).barrier()
    with open(os.path.join(root, ledger.LEDGER_BASENAME), "r", encoding="utf-8") as f:
        return f.read()


def test_two_proc_rank0_only_appends(tmp_path):
    """Ports ``test_two_proc_rank0_only_appends``: both ranks save, only
    rank 0 appends, and both read one stream."""
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    root = str(tmp_path / "ckpts")
    contents = run_multiprocess(_two_rank_ledger_worker, nproc=2, args=(root,), timeout=120.0)
    assert contents[0] == contents[1]
    records = [json.loads(line) for line in contents[0].splitlines() if line.strip()]
    events = [r["event"] for r in records]
    assert events.count(names.EVENT_RUN_START) == 1
    assert events.count(names.EVENT_STEP_COMMITTED) == 2
    assert events.count(names.EVENT_VISIBLE_STALL) == 2
    assert _events(records, names.EVENT_RUN_START)[0]["world_size"] == 2


def test_ledger_step_committed_cas_accounting(tmp_path):
    """Ports ``tests/test_cas.py::test_ledger_step_committed_cas_accounting``:
    on a chunk-store root the committed record carries the pin
    accounting (an identical second step is all reuse) and the digests'
    evidence."""
    state = _state(n=4, size=4096)
    root = str(tmp_path / "ckpt")
    with knobs.enable_cas(), knobs.enable_ledger():
        mgr = CheckpointManager(root, keep_last_n=5)
        mgr.save(0, {"s": TensorTreeState(dict(state))}, record_digests=True)
        mgr.save(1, {"s": TensorTreeState(dict(state))}, record_digests=True)
    first, second = _events(ledger.load_ledger(os.path.join(root, ".ledger.jsonl")), names.EVENT_STEP_COMMITTED)
    assert first["cas"] and second["cas"]
    assert first["bytes_reused"] == 0
    assert first["bytes_new"] == first["bytes_total"] > 0
    assert second["bytes_new"] == 0
    assert second["bytes_reused"] == second["bytes_total"] > 0
    assert second["chunks_new"] == 0 and second["chunks_reused"] > 0
    assert second["bytes_digest_unchanged"] == second["bytes_digest_covered"] > 0
