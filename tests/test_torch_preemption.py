"""PreemptionSaver of the port in one process: signal capture and chaining,
programmatic requests, the one-save-per-notice contract, drains and
handler restoration on close, and a preemption save through an incremental
CheckpointManager with retention GC, then a resume.

Ports of the single-process cases of the JAX package's
``tests/test_preemption.py`` and of
``tests/test_preemption_manager_composition.py`` with ``pg=None``. The
multi-rank agreement cases need the coordination store of the
multi-process port (ROADMAP queue 1 step 5). Every test that installs a
handler restores it in a ``finally``: a handler left behind, or a signal
sent without one, would kill the test worker. Restored tensors are
compared bit for bit.
"""

import os
import signal

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import (
    CheckpointManager,
    PreemptionSaver,
    Snapshot,
    StateDict,
    TensorTreeState,
)
from torchsnapshot_tpu_torch.fsck import verify_snapshot
from torchsnapshot_tpu_torch.manager import referenced_steps

torch.set_num_threads(1)


def test_single_process_signal_triggers_next_should_save() -> None:
    saver = PreemptionSaver(signals=(signal.SIGUSR1,))
    try:
        assert not saver.should_save(0)
        os.kill(os.getpid(), signal.SIGUSR1)
        assert saver.preempted
        assert saver.should_save(1)
        assert not saver.should_save(2)  # one save, not a save loop
    finally:
        saver.uninstall()


def test_request_save_without_signals() -> None:
    saver = PreemptionSaver(signals=())
    assert not saver.should_save(0)
    saver.request_save()
    assert saver.should_save(1)


def test_chained_handler_still_runs() -> None:
    hits = []
    prev = signal.signal(signal.SIGUSR2, lambda s, f: hits.append(s))
    try:
        saver = PreemptionSaver(signals=(signal.SIGUSR2,))
        try:
            os.kill(os.getpid(), signal.SIGUSR2)
            assert saver.preempted
            assert hits == [signal.SIGUSR2]
        finally:
            saver.uninstall()
    finally:
        signal.signal(signal.SIGUSR2, prev)


def test_sigterm_handler_installed_and_restored_by_close() -> None:
    """The default signal: SIGTERM flags the saver, and close() runs the
    registered drains and puts the previous handler back."""
    before = signal.getsignal(signal.SIGTERM)
    drained = []
    saver = PreemptionSaver()
    try:
        assert signal.getsignal(signal.SIGTERM) == saver._on_signal
        saver.register_drain(lambda: drained.append(1))
        saver.register_drain(lambda: 1 / 0)  # logged, never raised
        os.kill(os.getpid(), signal.SIGTERM)
        assert saver.should_save(7)
    finally:
        saver.close()
    assert drained == [1]
    assert signal.getsignal(signal.SIGTERM) == before


def test_pending_save_after_the_loop() -> None:
    """A notice that lands after the loop's last should_save call is
    reported once by pending_save()."""
    saver = PreemptionSaver(signals=())
    assert not saver.pending_save()
    for step in range(3):
        assert not saver.should_save(step)
    saver.request_save()
    assert saver.pending_save()
    assert not saver.pending_save() and not saver.should_save(3)


def test_process_group_refused() -> None:
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 step 5"):
        PreemptionSaver(pg=object(), signals=())


def _state(step: int) -> dict:
    # "frozen" never changes: every incremental save references step 0's
    # blob, so GC must pin step 0 long after the index dropped it. "hot"
    # changes every step: every save writes it anew.
    return {
        "train": TensorTreeState(
            {
                "frozen": torch.arange(4096, dtype=torch.float32),
                "hot": torch.full((2048,), float(step * 10), dtype=torch.float32),
            }
        ),
        "progress": StateDict(step=step),
    }


def test_preemption_save_through_incremental_manager_with_gc(tmp_path) -> None:
    root = str(tmp_path / "root")
    mgr = CheckpointManager(root, keep_last_n=2, incremental=True)
    for step in (0, 1, 2):
        mgr.save(step, _state(step))
    assert mgr.all_steps() == [1, 2]
    assert os.path.isdir(mgr.step_path(0)), "referenced base was deleted"

    saver = PreemptionSaver(signals=())
    saved_at = None
    try:
        for step in range(3, 200):
            if step == 5:
                saver.request_save()
            if saver.should_save(step):
                mgr.save(step, _state(step))
                saved_at = step
                if saver.exit_after_save:
                    break
    finally:
        saver.close()
    assert saved_at == 5

    # The eviction save took part in retention like a periodic one: step 1
    # (unreferenced) went, commit marker and every blob; step 0, referenced
    # by both retained manifests, stays pinned with its blobs.
    assert mgr.all_steps() == [2, saved_at]
    step1 = mgr.step_path(1)
    assert not os.path.exists(os.path.join(step1, ".snapshot_metadata"))
    leftover = [os.path.join(d, f) for d, _, fs in os.walk(step1) for f in fs]
    assert not leftover, f"dead step's blobs survived GC: {leftover}"
    assert os.path.exists(os.path.join(mgr.step_path(0), ".snapshot_metadata"))
    refs = referenced_steps(Snapshot(mgr.step_path(saved_at)).metadata.manifest)
    assert 0 in refs, f"eviction save did not chain (refs: {sorted(refs)})"
    for step in mgr.all_steps():
        report = verify_snapshot(mgr.step_path(step), deep=True)
        assert report.ok, (step, report.problems)

    # Restart: a fresh manager resumes from the eviction step.
    dest = {
        "train": TensorTreeState({"frozen": torch.zeros(4096), "hot": torch.zeros(2048)}),
        "progress": StateDict(step=-1),
    }
    assert CheckpointManager(root, incremental=True).restore_latest(dest) == saved_at
    assert dest["progress"]["step"] == saved_at
    np.testing.assert_array_equal(dest["train"].tree["frozen"].numpy(), np.arange(4096, dtype=np.float32))
    np.testing.assert_array_equal(
        dest["train"].tree["hot"].numpy(), np.full(2048, float(saved_at * 10), np.float32)
    )
