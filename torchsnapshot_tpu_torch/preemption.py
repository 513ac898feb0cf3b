"""Preemption-aware checkpointing: save once, consistently, when any host
receives an eviction signal.

Counterpart of ``torchsnapshot_tpu/preemption.py``. Training jobs are
preempted routinely (spot capacity, maintenance events), and the eviction
signal (SIGTERM, typically with a short grace window) may land on only
some hosts. A rank that checkpoints alone deadlocks its peers inside the
distributed take; ranks that checkpoint at different steps commit
garbage. :class:`PreemptionSaver` turns the signal into a whole-world
agreement to save at one specific step:

    mgr = CheckpointManager(root, pg=pg)
    saver = PreemptionSaver(pg=pg)           # installs a SIGTERM handler
    try:
        for step in range(start, total):
            state, loss = train_step(state, batch)
            if saver.should_save(step):      # no store traffic per step
                mgr.save(step, app_state)
                if saver.exit_after_save:
                    break
        else:
            if saver.pending_save():         # eviction raced the loop end
                mgr.save(total - 1, app_state)
    finally:
        saver.close()

Agreement protocol (sound when host loops drift relative to device
collectives, so "collectives order the ranks" arguments do not hold):

1. *Flag* (cheap steady state): a signaled rank sets one store key; a
   background poller on every rank watches it.
2. *Rendezvous* (once, after a rank observes the flag): each rank
   publishes its own current step and blocks until all ``world_size``
   ranks have published. Every rank then computes the same
   ``target = max(published) + 1``.
3. Each rank returns True from ``should_save`` exactly at
   ``step >= target``: the same step everywhere.

If the rendezvous does not complete within ``rendezvous_timeout`` (a
peer already died), the saver gives up loudly and never triggers.

In one process (``pg=None``) the signal alone decides: ``should_save``
returns True at the first step after it. The run-ledger posts of the JAX
saver (``ledger_root``) come with the telemetry port (ROADMAP queue 1
step 10), and its peer-tier flush on ``close`` with the peer tier (step
9).
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Any, List, Optional

from .pg_wrapper import PGWrapper

logger: logging.Logger = logging.getLogger(__name__)

_PREFIX = "__preemption"


class PreemptionSaver:
    """Coordinates one consistent whole-world save on an eviction signal.

    Args:
        pg: process group (as accepted by :class:`PGWrapper`); ``None``
            for single-process training.
        signals: signal numbers that mean "preemption imminent"
            (default: ``SIGTERM``). Pass ``()`` to install no handler
            and drive :meth:`request_save` manually (e.g. from a cloud
            metadata watcher thread).
        exit_after_save: advisory flag echoed back as
            ``saver.exit_after_save`` for the training loop.
        chain: when True (default), a previously-installed Python-level
            handler for the same signal is invoked after ours.
        rendezvous_timeout: seconds to wait for every rank to join the
            step agreement before giving up (default 120).
        poll_interval: seconds between background flag polls (default 1).
        peer_grace: seconds the final symmetry check sleeps before a
            triggered save, letting a just-timed-out peer's abandoned
            marker land. Defaults to ``max(1, 2 * poll_interval)``;
            deployments with slow coordination stores should widen it
            (the marker publish must fit inside it).
    """

    def __init__(
        self,
        pg: Optional[Any] = None,
        signals: tuple = (signal.SIGTERM,),
        exit_after_save: bool = True,
        chain: bool = True,
        rendezvous_timeout: float = 120.0,
        session: str = "",
        poll_interval: float = 1.0,
        peer_grace: Optional[float] = None,
    ) -> None:
        self._pg = PGWrapper(pg)
        # Store keys are namespaced per session: saver lifetimes sharing
        # one persistent store (restarted loops, tests over one
        # coordinator) must not observe each other's stale flag/step
        # keys. Pass a distinct, rank-consistent session per lifetime
        # (e.g. the resume step) when the store outlives the saver.
        self._session = session
        self.exit_after_save = exit_after_save
        self.rendezvous_timeout = rendezvous_timeout
        self.poll_interval = poll_interval
        self.peer_grace = (
            peer_grace
            if peer_grace is not None
            else max(1.0, 2.0 * poll_interval)
        )
        self._flagged = threading.Event()
        self._remote_flagged = threading.Event()
        self._drains: List[Any] = []
        self._stop_poller = threading.Event()
        self._poller: Optional[threading.Thread] = None
        self._flag_published = False
        self._target_step: Optional[int] = None
        self._saved = False
        self._gave_up = False
        self._chain = chain
        self._prev_handlers: List[tuple] = []
        for sig in signals:
            prev = signal.signal(sig, self._on_signal)
            self._prev_handlers.append((sig, prev))
        if signals:
            logger.info(
                "PreemptionSaver armed on %s (rank %d/%d)",
                [signal.Signals(s).name for s in signals],
                self._pg.get_rank(),
                self._pg.get_world_size(),
            )

    def _key(self, suffix: str) -> str:
        return f"{_PREFIX}/{self._session}/{suffix}"

    def _ensure_poller(self, store) -> None:
        """Background flag watcher: the training loop's should_save does
        no store RPC in the steady state — one daemon thread per rank
        polls the flag key every ``poll_interval`` seconds and flips a
        local Event (store clients serialize requests internally, so the
        poller and a later rendezvous never interleave corruptly)."""
        if self._poller is not None:
            return

        def poll() -> None:
            # Never give up: a poller that exits on a coordinator hiccup
            # leaves this rank blind to remote eviction notices, and a
            # later real preemption then degrades to peers blocking out
            # the full rendezvous timeout. Failures back off
            # exponentially (capped) so an unhealthy store isn't hammered.
            failures = 0
            cap = max(30.0, 16.0 * self.poll_interval)
            delay = self.poll_interval
            while not self._stop_poller.wait(delay):
                try:
                    if store.try_get(self._key("flag")) is not None:
                        self._remote_flagged.set()
                        return
                    failures = 0
                    delay = self.poll_interval
                except Exception as e:  # noqa: BLE001 - transient store hiccup
                    failures += 1
                    delay = min(cap, delay * 2.0)
                    log = logger.error if delay >= cap else logger.warning
                    log(
                        "preemption flag poll failed %d time(s) (%r); "
                        "retrying in %.1fs",
                        failures,
                        e,
                        delay,
                    )

        self._poller = threading.Thread(
            target=poll, name="preemption-flag-poll", daemon=True
        )
        self._poller.start()

    # -- signal side (async-signal-safe: only sets an Event) -------------

    def _on_signal(self, signum, frame) -> None:
        self._flagged.set()
        if self._chain:
            for sig, prev in self._prev_handlers:
                if sig == signum and callable(prev):
                    prev(signum, frame)

    def request_save(self) -> None:
        """Programmatic preemption notice (metadata watchers, tests)."""
        self._flagged.set()

    @property
    def preempted(self) -> bool:
        """True once a signal/request has been observed locally."""
        return self._flagged.is_set()

    def register_drain(self, fn: Any) -> None:
        """Register a zero-arg callable run during :meth:`close`, before
        the done marker publishes, to flush work that must fit the
        eviction grace window (an async save's ``wait()``, an upload).
        On a tiered root, the mirror's drain::

            saver.register_drain(lambda: tiered.get_mirror().drain(timeout=grace_s))

        pushes in-flight durable uploads out before the host goes; what
        misses the window is journaled, so the restarted job's
        ``CheckpointManager.resume_mirrors()`` resumes it without
        re-sending completed blobs. Drain failures are logged, never
        raised (close() runs on the teardown path)."""
        self._drains.append(fn)

    def uninstall(self) -> None:
        """Restore previously-installed signal handlers."""
        for sig, prev in self._prev_handlers:
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        self._prev_handlers = []

    def close(self) -> None:
        """Call when the training loop exits normally (no more
        ``should_save`` calls coming). Publishes a done marker so a peer
        whose eviction notice raced the end of training abandons its
        rendezvous immediately instead of waiting out the timeout, and
        restores the signal handlers."""
        self._stop_poller.set()
        if self._poller is not None:
            self._poller.join(timeout=self.poll_interval + 1.0)
        for fn in self._drains:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - teardown path
                logger.warning("preemption drain hook failed: %r", e)
        store = self._pg.store
        if store is not None and self._pg.get_world_size() > 1:
            try:
                # Session-namespaced tombstone: it must outlive this
                # process so a straggler's rendezvous can see the peer
                # finished. The session id scopes the whole family; a
                # new job incarnation starts a fresh namespace.
                store.set(self._key(f"done/{self._pg.get_rank()}"), b"1")
            except Exception:  # noqa: BLE001 - teardown path
                logger.debug("preemption done-marker publish failed")
        self.uninstall()

    # -- training-loop side ----------------------------------------------

    def should_save(self, step: int) -> bool:
        """Call once per training step with that step's number.

        Returns True on the one step at which every rank must save
        (``step`` itself on single-process worlds)."""
        if self._saved or self._gave_up:
            return False
        store = self._pg.store
        if store is None or self._pg.get_world_size() <= 1:
            if self._flagged.is_set():
                self._saved = True
                return True
            return False

        if self._target_step is None:
            # Steady state: NO store RPC on the training loop — the
            # background poller watches the flag; a locally-signaled
            # rank publishes it once.
            self._ensure_poller(store)
            if self._flagged.is_set() and not self._flag_published:
                # One sticky flag per session: deleting it could lose
                # the notice for ranks that have not polled yet.
                store.set(self._key("flag"), b"1")
                self._flag_published = True
                self._remote_flagged.set()
                logger.warning(
                    "rank %d received preemption notice at step %d",
                    self._pg.get_rank(),
                    step,
                )
            if not self._remote_flagged.is_set():
                return False
            self._target_step = self._agree_on_target(step)
            if self._target_step is None:
                self._give_up(store)
                return False
            logger.warning(
                "preemption agreed: world saves at step %d",
                self._target_step,
            )
        if step >= self._target_step:
            if self._peer_abandoned_after_grace(store):
                self._give_up(store)
                return False
            self._saved = True
            return True
        return False

    def _peer_abandoned_after_grace(self, store) -> bool:
        """Final symmetry check before triggering a save: a peer may have
        timed out of the rendezvous just as ours completed, and saving
        without it would be a lone save (permanent block inside the
        distributed take). The grace sleep outlasts the gap between a
        peer's deadline expiry and its abandoned-marker publish — cheap
        against the checkpoint we are about to write. Residual window: a
        peer whose marker *publish itself* stalls longer than the grace
        (store unreachable during the eviction) can still be missed;
        timeout-based agreement cannot close that without a third phase,
        and a store that broken would fail the save anyway. A raised
        store read is retried within a short window (one hiccup on one
        rank must not abort its save while peers proceed into the take
        and block on its absence); a *persistently* failing store is
        grounds to give up: that is exactly when "no abandon marker
        seen" must not be read as an all-clear for a possibly-lone
        save."""
        time.sleep(self.peer_grace)
        deadline = time.monotonic() + max(2.0, self.peer_grace)
        # The abandoned marker IS this loop's abort channel (there is no
        # round error key — preemption is not a fan-out round), and the
        # loop only spins on *store read failures*, bounded by the
        # deadline above.
        while True:
            try:
                return store.try_get(self._key("abandoned")) is not None
            except Exception as e:  # noqa: BLE001 - unhealthy store
                if time.monotonic() >= deadline:
                    logger.error(
                        "preemption symmetry check could not read the "
                        "store (%r); abandoning the coordinated save "
                        "rather than risk a lone take",
                        e,
                    )
                    return True
                logger.warning(
                    "preemption symmetry check read failed (%r); retrying",
                    e,
                )
                time.sleep(0.1)

    def pending_save(self) -> bool:
        """One-shot check for an agreed save the loop never reached.

        The agreed target can exceed the loop's final step (eviction
        landing while the leading rank runs its last steps). Every rank
        exits the loop unsaved in that case — call this after the loop
        and save at the final step if it returns True. Symmetric: a
        completed rendezvous means every rank holds the same target (a
        timed-out or abandoned rendezvous gives up on every rank), so
        either all ranks see True here or none do::

            for step in range(total):
                ...
                if saver.should_save(step):
                    mgr.save(step, app_state); break
            else:
                if saver.pending_save():
                    mgr.save(total - 1, app_state)
            saver.close()
        """
        if (
            self._saved
            or self._gave_up
            or (self._target_step is None and not self._flagged.is_set())
        ):
            return False
        if self._pg.store is None or self._pg.get_world_size() <= 1:
            self._saved = True
            return True
        if self._target_step is None:
            return False  # flagged but never agreed: peers may be done
        if self._peer_abandoned_after_grace(self._pg.store):
            self._give_up(self._pg.store)
            return False
        self._saved = True
        return True

    def _give_up(self, store) -> None:
        """Abandon the coordinated save — and tell peers, so a rank whose
        rendezvous would otherwise complete against this rank's stale
        step key cannot save alone (the asymmetric-deadlock case)."""
        self._gave_up = True
        try:
            # Sticky per-session tombstone, same contract as done/:
            # peers must read it after this process is gone.
            store.set(self._key("abandoned"), b"1")
        except Exception:  # noqa: BLE001 - already giving up
            logger.debug("preemption abandoned-marker publish failed")
        logger.error(
            "preemption rendezvous abandoned (timeout %.0fs or a peer "
            "finished training); coordinated save will not happen — "
            "periodic checkpoints are the fallback",
            self.rendezvous_timeout,
        )

    def _agree_on_target(self, step: int) -> Optional[int]:
        """Blocking max-step rendezvous; identical result on every rank,
        or None when it must be abandoned (timeout, a finished peer, or
        a peer that already abandoned)."""
        store = self._pg.store
        rank = self._pg.get_rank()
        world = self._pg.get_world_size()
        # The rendezvous happens at most once per session (the process
        # is being evicted); its keys are session-namespaced and must
        # survive until the last straggler reads them — there is no
        # safe point to delete (a late joiner re-reads every step key).
        store.set(self._key(f"step/{rank}"), str(step).encode())
        joined = store.add(self._key("step_count"), 1)
        deadline = time.monotonic() + self.rendezvous_timeout
        # Steady wait costs ONE coordinator RPC per 50ms tick (the join
        # counter); per-rank step keys are read once, after the counter
        # says everyone published. done/abandoned are coarse conditions
        # (a finished or timed-out peer aborts the save either way):
        # checked ~1/s.
        next_abort_check = 0.0
        # abandoned/done ARE the abort channels here (checked ~1/s in
        # the loop body), and the fixed 50ms tick is the documented cost
        # model above — a pacer's backoff would slow the join counter,
        # the thing this loop exists to watch.
        while time.monotonic() < deadline:
            if time.monotonic() >= next_abort_check:
                next_abort_check = time.monotonic() + 1.0
                try:
                    if store.try_get(self._key("abandoned")) is not None:
                        logger.error(
                            "a peer abandoned the preemption rendezvous"
                        )
                        return None
                    for r in range(world):
                        if store.try_get(self._key(f"done/{r}")) is not None:
                            # A peer that finished training will never
                            # join; abandon now, not at the timeout.
                            logger.error(
                                "rank %d finished training before joining "
                                "the preemption rendezvous",
                                r,
                            )
                            return None
                except Exception as e:  # noqa: BLE001 - transient store hiccup
                    # Abort checks are best-effort; the deadline bounds a
                    # persistently failing store (rendezvous then gives
                    # up, which is the safe outcome).
                    logger.warning(
                        "preemption abort check failed (%r); retrying", e
                    )
            if joined < world:
                try:
                    joined = store.add(self._key("step_count"), 0)
                except Exception as e:  # noqa: BLE001 - transient store hiccup
                    logger.warning(
                        "preemption join-count poll failed (%r); retrying", e
                    )
            if joined >= world:
                try:
                    steps: List[Optional[bytes]] = [
                        store.try_get(self._key(f"step/{r}"))
                        for r in range(world)
                    ]
                except Exception as e:  # noqa: BLE001 - transient store hiccup
                    # Same best-effort treatment as the abort checks: the
                    # deadline bounds a persistently failing store.
                    logger.warning(
                        "preemption step-key read failed (%r); retrying", e
                    )
                    steps = []
                if steps and all(s is not None for s in steps):
                    return max(int(s.decode()) for s in steps) + 1
            time.sleep(0.05)
        return None
