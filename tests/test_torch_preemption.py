"""PreemptionSaver of the port: signal capture and chaining, programmatic
requests, the one-save-per-notice contract, drains and handler restoration
on close; the multi-rank agreement (drifted ranks, a peer that finished,
rendezvous timeouts and the abandoned marker, session namespacing, a
timing fuzz) over an InProcessStore; and the eviction save through an
incremental CheckpointManager with retention GC, then a resume, in one
process and in two and four spawned ranks.

Ports of the JAX package's ``tests/test_preemption.py`` and
``tests/test_preemption_manager_composition.py``. The spawned workers
import this module and never ``jax``. Every test that installs a handler
restores it in a ``finally``: a handler left behind, or a signal sent
without one, would kill the test worker. Restored tensors are compared
bit for bit.
"""

import os
import signal
import threading
import time

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


# ---------------------------------------------------------------------------
# Multi-rank agreement
# ---------------------------------------------------------------------------


def _pg(store, rank: int, world: int = 2):
    from torchsnapshot_tpu_torch.dist_store import ProcessGroup

    return ProcessGroup(store, rank, world)


def test_agreement_with_drifted_ranks_in_process() -> None:
    """Two ranks drifted by several steps agree on one target step: the
    rendezvous takes max(published) + 1, so the laggard catches up
    instead of the leader saving in the past."""
    from torchsnapshot_tpu_torch.dist_store import InProcessStore

    store = InProcessStore()
    s0 = PreemptionSaver(_pg(store, 0), signals=())
    s1 = PreemptionSaver(_pg(store, 1), signals=())
    # Rank 1 is signaled at step 7 while rank 0's loop is at step 4.
    # Rank 0's rendezvous entry is seeded (and the counter the rendezvous
    # waits on joined) so that the blocking agreement completes in one
    # thread.
    s1.request_save()
    s0.request_save()
    store.set("__preemption//step/0", b"4")
    store.add("__preemption//step_count", 1)
    assert not s1.should_save(7)  # target = max(4, 7) + 1 = 8
    assert s1._target_step == 8
    assert [step for step in range(4, 10) if s0.should_save(step)] == [8]
    assert s0._target_step == 8
    assert [step for step in range(8, 10) if s1.should_save(step)] == [8]


def test_done_peer_abandons_rendezvous_fast() -> None:
    """A peer that finished training (close()) makes the rendezvous
    abandon at once instead of waiting out the timeout."""
    from torchsnapshot_tpu_torch.dist_store import InProcessStore

    store = InProcessStore()
    s0 = PreemptionSaver(_pg(store, 0), signals=())
    s1 = PreemptionSaver(_pg(store, 1), signals=(), rendezvous_timeout=30.0)
    s0.close()
    s1.request_save()
    t0 = time.monotonic()
    assert not s1.should_save(5)
    assert time.monotonic() - t0 < 5.0  # the done marker, not the 30 s timeout
    assert s1._gave_up


def test_rendezvous_timeout_gives_up_loudly() -> None:
    """A missing peer aborts the coordinated save, permanently: a lone
    save would deadlock inside the distributed take."""
    from torchsnapshot_tpu_torch.dist_store import InProcessStore

    saver = PreemptionSaver(_pg(InProcessStore(), 0), signals=(), rendezvous_timeout=0.3)
    saver.request_save()
    assert not saver.should_save(3)
    assert saver._gave_up
    assert not saver.should_save(4)


def test_timeout_publishes_abandoned_marker_peers_give_up() -> None:
    """A timed-out rank leaves its step key behind; a late peer must not
    complete the rendezvous against it and save alone."""
    from torchsnapshot_tpu_torch.dist_store import InProcessStore

    store = InProcessStore()
    s0 = PreemptionSaver(_pg(store, 0), signals=(), rendezvous_timeout=0.2)
    s0.request_save()
    assert not s0.should_save(3)
    s1 = PreemptionSaver(_pg(store, 1), signals=())
    s1.request_save()
    assert not s1.should_save(5)
    assert s1._gave_up


def test_pending_save_when_target_past_loop_end() -> None:
    """An agreed target beyond the final step: every rank leaves the loop
    unsaved and pending_save() fires once on each."""
    from torchsnapshot_tpu_torch.dist_store import InProcessStore

    store = InProcessStore()
    s0 = PreemptionSaver(_pg(store, 0), signals=())
    s1 = PreemptionSaver(_pg(store, 1), signals=())
    last_step = 9
    s1.request_save()
    s0.request_save()
    store.set("__preemption//step/0", str(last_step).encode())
    store.add("__preemption//step_count", 1)
    assert not s1.should_save(last_step)
    assert s1._target_step == last_step + 1
    assert not s0.should_save(last_step)
    assert s0._target_step == last_step + 1
    assert s0.pending_save() and s1.pending_save()
    assert not s0.pending_save()  # one-shot


def test_session_namespacing_isolates_stale_state() -> None:
    """A fresh saver lifetime over the same store does not observe a
    previous session's flag and step keys."""
    from torchsnapshot_tpu_torch.dist_store import InProcessStore

    store = InProcessStore()
    store.set("__preemption/run1/flag", b"1")
    store.set("__preemption/run1/step/0", b"7")
    store.set("__preemption/run1/step/1", b"7")
    store.add("__preemption/run1/step_count", 2)
    fresh = PreemptionSaver(_pg(store, 0), signals=(), session="run2", rendezvous_timeout=0.2)
    assert not fresh.should_save(0)
    assert fresh._target_step is None and not fresh._gave_up
    stale = PreemptionSaver(_pg(store, 0), signals=(), session="run1")
    stale.request_save()
    assert not stale.should_save(7)  # completes run1's rendezvous: target 8
    assert stale._target_step == 8


@pytest.mark.parametrize("seed", range(4))
def test_agreement_timing_fuzz(seed) -> None:
    """Randomized timing (eviction step and rank, poll interval, the two
    thread-ranks' pacing): both ranks save the same step."""
    from torchsnapshot_tpu_torch.dist_store import InProcessStore

    rng = np.random.default_rng(8000 + seed)
    store = InProcessStore()
    evict_rank = int(rng.integers(0, 2))
    evict_step = int(rng.integers(0, 60))
    poll = float(rng.choice([0.01, 0.03, 0.05]))
    paces = [float(rng.choice([0.001, 0.004, 0.01])) for _ in range(2)]
    saved = {}

    def loop(rank: int) -> None:
        saver = PreemptionSaver(
            _pg(store, rank), signals=(), poll_interval=poll, rendezvous_timeout=30.0,
            peer_grace=0.1, session=f"fuzz{seed}",
        )
        for step in range(5000):
            if rank == evict_rank and step == evict_step:
                saver.request_save()
            if saver.should_save(step):
                saved[rank] = step
                return
            time.sleep(paces[rank])
        saved[rank] = None

    threads = [threading.Thread(target=loop, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert saved.get(0) is not None, saved
    assert saved.get(0) == saved.get(1), saved


def _preempt_e2e_worker(pg, root: str, evict_rank: int = 1):
    """One rank is evicted mid-loop; every rank saves the same step
    through the manager, and the checkpoint resumes. Sameness is the
    invariant, not the number."""
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
    from torchsnapshot_tpu_torch.test_utils import drive_preemption_loop

    PGWrapper(pg).barrier()
    mgr = CheckpointManager(root, pg=pg)
    saver = PreemptionSaver(pg, signals=(), poll_interval=0.1)

    def save(step: int) -> None:
        # Step s has applied s + 1 increments to the zero-initialized w.
        state = {"w": torch.full((8,), float(step + 1)), "step": step}
        mgr.save(step, {"train": TensorTreeState(state), "prog": StateDict(r=pg.rank)})

    saved_at = drive_preemption_loop(pg, saver, save, evict_rank=evict_rank)
    assert saved_at is not None, "world never agreed on a save step"
    dest = {"train": TensorTreeState({"w": torch.zeros(8), "step": 0}), "prog": StateDict(r=-1)}
    assert mgr.restore_latest(dest) == saved_at
    assert torch.equal(dest["train"].tree["w"], torch.full((8,), float(saved_at + 1)))
    assert dest["prog"]["r"] == pg.rank
    return saved_at


def test_preemption_save_and_resume_two_ranks(tmp_path) -> None:
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    saved = run_multiprocess(_preempt_e2e_worker, nproc=2, args=(str(tmp_path / "preempt"),))
    assert saved[0] == saved[1], saved
    assert saved[0] is not None and saved[0] >= 3, saved


def test_preemption_four_ranks_one_agreed_step(tmp_path) -> None:
    """Four ranks, a notice on rank 2 only: every rank saves the same
    step and the checkpoint resumes on all of them."""
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    saved = run_multiprocess(
        _preempt_e2e_worker, nproc=4, args=(str(tmp_path / "preempt4"),),
        kwargs={"evict_rank": 2}, timeout=300.0,
    )
    assert len(set(saved)) == 1 and saved[0] is not None, saved


def _composition_state(rank: int, step: int) -> dict:
    # "frozen" never changes: every incremental save references step 0's
    # blob, so GC must pin step 0 long after the index dropped it. "hot"
    # changes every step.
    return {
        "train": TensorTreeState(
            {
                "frozen": torch.arange(4096, dtype=torch.float32) + rank,
                "hot": torch.full((2048,), float(step * 10 + rank)),
            }
        ),
        "progress": StateDict(step=step),
    }


def _composition_worker(pg, root: str):
    import shutil

    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
    from torchsnapshot_tpu_torch.test_utils import drive_preemption_loop

    if pg.rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    wrapper = PGWrapper(pg)
    wrapper.barrier()
    mgr = CheckpointManager(root, keep_last_n=2, pg=pg, incremental=True)
    for step in (0, 1, 2):
        mgr.save(step, _composition_state(pg.rank, step))
    wrapper.barrier()  # rank 0's index write and GC are durable
    assert mgr.all_steps() == [1, 2]
    assert os.path.isdir(mgr.step_path(0)), "referenced base was deleted"

    saver = PreemptionSaver(pg, signals=(), poll_interval=0.02, rendezvous_timeout=30.0, session="mgr-comp")
    saved_at = drive_preemption_loop(
        pg, saver, save_fn=lambda step: mgr.save(step, _composition_state(pg.rank, step)),
        evict_rank=1, evict_step=5, steps=200,
    )
    assert saved_at is not None, "eviction save never triggered"
    agreed = wrapper.all_gather_object(saved_at)
    assert agreed[0] == agreed[1] == saved_at, agreed
    wrapper.barrier()  # rank 0's eviction-save commit and GC are done

    assert mgr.all_steps() == [2, saved_at]
    step1 = mgr.step_path(1)
    assert not os.path.exists(os.path.join(step1, ".snapshot_metadata"))
    leftover = [os.path.join(d, f) for d, _, fs in os.walk(step1) for f in fs]
    assert not leftover, f"dead step's blobs survived GC: {leftover}"
    assert os.path.exists(os.path.join(mgr.step_path(0), ".snapshot_metadata"))
    refs = referenced_steps(Snapshot(mgr.step_path(saved_at), pg=pg).metadata.manifest)
    assert 0 in refs, f"eviction save did not chain (refs: {sorted(refs)})"
    for step in mgr.all_steps():
        report = verify_snapshot(mgr.step_path(step), deep=True)
        assert report.ok, (step, report.problems)
    wrapper.barrier()

    mgr2 = CheckpointManager(root, pg=pg, incremental=True)
    dest = {
        "train": TensorTreeState({"frozen": torch.zeros(4096), "hot": torch.zeros(2048)}),
        "progress": StateDict(step=-1),
    }
    assert mgr2.restore_latest(dest) == saved_at
    assert dest["progress"]["step"] == saved_at
    assert torch.equal(dest["train"].tree["frozen"], torch.arange(4096, dtype=torch.float32) + pg.rank)
    assert torch.equal(dest["train"].tree["hot"], torch.full((2048,), float(saved_at * 10 + pg.rank)))
    return saved_at


def test_preemption_save_through_incremental_manager_with_gc_two_ranks(tmp_path) -> None:
    """Periodic incremental saves, retention GC with ref pinning, an
    eviction save agreed by two ranks through the same manager (chaining
    off the last periodic step), deep fsck of every retained step, and a
    resume by a fresh manager."""
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    saved = run_multiprocess(_composition_worker, nproc=2, args=(str(tmp_path / "root"),))
    assert saved[0] == saved[1]
