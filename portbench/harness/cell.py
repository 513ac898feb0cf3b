"""One run of one cell: set-up, the measured window, the checks.

The loop is closed: one training loop a rank, each step after the last.
Set-up builds the train state through the architecture's adapter
(``harness/arch.py``), loads the benchmark's weights into it, runs three
steps (the ones the reference follows), opens the program's
``CheckpointManager`` and makes one warm-up save (and, for ``restart``,
one warm-up restore), so that the window finds the pinned host buffers
allocated, as a long job does. The window trains until ``--seconds``
have passed, at a step boundary, and saves or restores at the traffic's
marks (fractions of ``--seconds``).

With more than one rank the parent process is rank 0 and spawns the
others, one card each; rank 0 decides every step's action and broadcasts
it over a gloo group, so that every rank saves after the same step.
"""

from __future__ import annotations

import gc
import math
import multiprocessing
import os
import shutil
import socket
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import check, data
from .arith import PEAK_BF16_FLOPS
from .guard import forbidden_modules
from .spec import Cell
from .trace import Profile, Spans

WARMUP_STEPS = 3
ACTIONS = ("step", "save", "restore", "stop")
APP_KEY = "train"
CHILD_JOIN_S = 120.0


# ----------------------------------------------------------------------
# control between ranks
# ----------------------------------------------------------------------


class Control:
    """One rank: every decision is its own."""

    rank, world = 0, 1

    def decide(self, action: str) -> str:
        return action

    def barrier(self) -> None:
        pass

    def gather(self, obj: Any) -> Optional[List[Any]]:
        return [obj]


class DistControl(Control):
    """Rank 0 decides, over the default (gloo) group."""

    def __init__(self) -> None:
        import torch.distributed as dist

        self.dist = dist
        self.rank, self.world = dist.get_rank(), dist.get_world_size()

    def decide(self, action: str) -> str:
        t = torch.tensor([ACTIONS.index(action) if self.rank == 0 else 0])
        self.dist.broadcast(t, 0)
        return ACTIONS[int(t.item())]

    def barrier(self) -> None:
        self.dist.barrier()

    def gather(self, obj: Any) -> Optional[List[Any]]:
        out = [None] * self.world if self.rank == 0 else None
        self.dist.gather_object(obj, out, dst=0)
        return out


# ----------------------------------------------------------------------
# set-up
# ----------------------------------------------------------------------


def sync(device: torch.device) -> None:
    """The end of this rank's own stream (not a background drain's copies)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@dataclass
class Trained:
    """The train state after the warm-up steps, and what the program read
    on the way: each step's loss, each trained leaf's first gradient norm
    worked out from AdamW's first moment, each trained leaf's change over
    the steps."""

    state: Any
    train_step: Callable
    feed: data.TokenFeed
    batches: List[torch.Tensor]
    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]
    first_moments: Dict[str, torch.Tensor]  # AdamW's exp_avg after step 1, on the host
    first_scale: float  # 1 / (1 - beta1): first moment -> first gradient


def train_warmup(
    cell: Cell, seed: int, device: torch.device,
    wrap_step: Optional[Callable[[Callable], Callable]] = None,
) -> Trained:
    """Build the state from ``seed`` and drive it through its first steps
    with the window's own call and feed."""
    d, leaves = cell.dims, cell.leaves
    state, train_step, params_of = cell.arch.build(
        d, cell.config["run"], data.stream_seed(seed, data.TRAIN_RNG), device
    )
    weights = cell.weights(seed, device)
    every = params_of(state)
    if {n: tuple(t.shape) for n, t in every.items()} != {n: tuple(leaf.shape) for n, leaf in leaves.items()}:
        raise ValueError(f"{cell.config_name}: the program's leaves differ from the adapter's leaf_shapes")
    with torch.no_grad():
        for name, t in every.items():
            t.copy_(weights[name])
    live = {n: every[n] for n, leaf in leaves.items() if leaf.trained}
    if wrap_step is not None:
        train_step = wrap_step(train_step)
    feed = data.TokenFeed(d, seed, device)
    beta1 = cell.config["run"]["adamw"]["betas"][0]
    batches, losses, grad_norms, first_moments = [], [], {}, {}
    for i in range(WARMUP_STEPS):
        tokens = feed.next()
        batches.append(tokens)
        _, loss = train_step(state, tokens)
        losses.append(float(loss))
        if i == 0:
            # Norms on the device, as the reference takes them: a float32
            # norm of a 39M-element leaf summed on the host is off by ~1e-3.
            moments = [state.optimizer.state[t]["exp_avg"].detach() for t in live.values()]
            norms = [m.float().norm() / (1 - beta1) for m in moments]
            grad_norms = dict(zip(live, torch.stack(norms).tolist()))
            first_moments = {name: m.to("cpu", copy=True) for name, m in zip(live, moments)}
    with torch.no_grad():
        changes = torch.stack([(t.float() - weights[n].float()).norm() for n, t in live.items()]).tolist()
    del weights
    return Trained(
        state=state, train_step=train_step, feed=feed, batches=batches, losses=losses,
        grad_norms=grad_norms, change_norms=dict(zip(live, changes)),
        first_moments=first_moments, first_scale=1.0 / (1 - beta1),
    )


def state_fingerprints(state: Any) -> Dict[str, Tuple]:
    return data.fingerprints(data.flatten(state.state_dict()))


def registry_view() -> Tuple[Dict[str, float], Dict[str, Dict[str, float]]]:
    """The program's registry counters and histogram sums and counts."""
    from torchsnapshot_tpu_torch import telemetry

    dump = telemetry.metrics().collect()
    hist = {
        "sum": {k: h["sum"] for k, h in dump["histograms"].items()},
        "count": {k: float(h["count"]) for k, h in dump["histograms"].items()},
    }
    return dict(dump["counters"]), hist


def _delta(after: Dict[str, float], before: Dict[str, float]) -> Dict[str, float]:
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v - before.get(k, 0.0)}


# ----------------------------------------------------------------------
# one rank's run
# ----------------------------------------------------------------------


@dataclass
class RankResult:
    rank: int
    window_s: float = 0.0
    setup_done_s: float = 0.0  # monotonic time of the window's first step
    steps: List[Tuple[float, str]] = field(default_factory=list)  # seconds, "step" or "drain"
    saves: List[Dict[str, Any]] = field(default_factory=list)
    restores: List[Dict[str, Any]] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)
    histograms: Dict[str, Dict[str, float]] = field(default_factory=dict)
    written_total: float = 0.0
    trace: Optional[Dict[str, Any]] = None
    memory_peak_bytes: int = 0
    checks: Dict[str, Any] = field(default_factory=dict)
    forbidden: List[str] = field(default_factory=list)  # a spawned rank's, once its window closed


def run_rank(
    cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
    ctl: Control, root: str, wrap_step: Optional[Callable[[Callable], Callable]] = None,
) -> RankResult:
    """Set-up, window and checks of one rank; rank 0's result carries the
    training check and the checks of what reached storage."""
    from torchsnapshot_tpu_torch import telemetry
    from torchsnapshot_tpu_torch.manager import CheckpointManager

    traffic, run_cfg = cell.traffic, cell.config["run"]
    loop, mode = traffic["loop"], traffic.get("mode", "sync")
    take_kwargs = {"replicated": traffic["replicated"]} if "replicated" in traffic else {}
    pg = None
    if ctl.world > 1:
        from torchsnapshot_tpu_torch.dist_store import torch_process_group

        pg = torch_process_group()

    trained = train_warmup(cell, seed, device, wrap_step)
    state, train_step, feed = trained.state, trained.train_step, trained.feed
    manager = CheckpointManager(root, pg=pg, **run_cfg["manager"])
    app = {APP_KEY: state}
    expected = None
    if loop == "save" and mode == "async":
        manager.async_save(state.step, app, **take_kwargs).wait()
    else:
        if loop == "restart":
            expected = state_fingerprints(state)
        manager.save(state.step, app, **take_kwargs)
    setup_save_path = manager.step_path(state.step)
    if loop == "restart":
        # One restore after the save and one after a training step, as the
        # window's come: the first restore that follows training steps was
        # 0.2-0.4 s slower than the rest when set-up made only the first.
        manager.restore_latest(app)
        train_step(state, feed.next())
        manager.restore_latest(app)
    sync(device)

    res = RankResult(rank=ctl.rank)
    marks = list(traffic["marks"])
    spans = Spans()
    prof = Profile(trace, cell.arch.kernels(cell.dims))
    counters0, hist0 = registry_view()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    pending: Any = None
    pending_rec: Dict[str, Any] = {}
    ctl.barrier()
    prof.start()
    t0 = time.monotonic()
    res.setup_done_s = t0
    while True:
        kind = "drain" if pending is not None else "step"
        with spans.span(kind):
            s0 = time.monotonic()
            train_step(state, feed.next())
            sync(device)
            res.steps.append((time.monotonic() - s0, kind))
        if pending is not None and pending.done():
            with spans.span("commit"):
                pending.wait()
            pending_rec["committed_s"] = pending.committed_s
            res.saves.append(pending_rec)
            pending = None
        elapsed = time.monotonic() - t0
        if marks and pending is None and elapsed >= marks[0] * seconds:
            want = "restore" if loop == "restart" else "save"
        elif not marks and elapsed >= seconds and pending is None:
            want = "stop"
        else:
            want = "step"
        action = ctl.decide(want)
        if action == "stop":
            break
        if action == "step":
            continue
        marks.pop(0)
        if action == "save":
            with spans.span("fingerprint"):
                at_call = state_fingerprints(state)
            step_no = state.step
            with spans.span("save"):
                c0 = time.monotonic()
                if mode == "async":
                    pending = manager.async_save(step_no, app, **take_kwargs)
                else:
                    manager.save(step_no, app, **take_kwargs)
                call_s = time.monotonic() - c0
            rec = {"step": step_no, "path": manager.step_path(step_no), "fp": at_call, "call_s": call_s}
            if pending is not None:
                pending_rec = rec
            else:
                res.saves.append(rec)
        else:
            with spans.span("restore"):
                c0 = time.monotonic()
                manager.restore_latest(app)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                took = time.monotonic() - c0
            with spans.span("fingerprint"):
                res.restores.append({"s": took, "fp": state_fingerprints(state)})
    res.window_s = time.monotonic() - t0
    prof.stop()
    if device.type == "cuda":
        res.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    counters1, hist1 = registry_view()
    res.counters = _delta(counters1, counters0)
    res.histograms = {k: _delta(hist1[k], hist0[k]) for k in ("sum", "count")}
    res.written_total = sum(
        v for k, v in counters1.items() if k.partition("{")[0] == telemetry.names.STORAGE_WRITE_BYTES_TOTAL
    )
    res.trace = prof.reduce(spans.spans) if trace else None

    # The window is closed and read: free the program's state, then check.
    del state, app, train_step, manager, pending, trained.state, trained.train_step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    res.checks = checks_of_rank(cell, res, expected)
    res.checks["setup_save"] = (setup_save_path, expected)
    if ctl.rank == 0:  # only rank 0's first steps are held to the reference
        res.checks["program"] = {
            "losses": trained.losses, "grad_norms": trained.grad_norms,
            "change_norms": trained.change_norms, "batches": [b.cpu() for b in trained.batches],
            "first_moments": trained.first_moments, "first_scale": trained.first_scale,
        }
    return res


def checks_of_rank(cell: Cell, res: RankResult, expected: Optional[Dict[str, Tuple]]) -> Dict[str, Any]:
    """What each rank compares by itself: its restores against the saved state."""
    out: Dict[str, Any] = {"restore_mismatched": []}
    for i, r in enumerate(res.restores):
        bad = check.mismatched(expected or {}, r.pop("fp"))
        if bad:
            out["restore_mismatched"].append((i, bad[:5], len(bad)))
    return out


# ----------------------------------------------------------------------
# the checks rank 0 makes after the window
# ----------------------------------------------------------------------


def check_saved(path: str, expected: List[Dict[str, Tuple]], device: torch.device) -> List[str]:
    """Leaves of the snapshot at ``path`` that differ from any rank's state
    at the call, or that one side lacks."""
    from reference.reader import read_snapshot

    try:
        leaves = read_snapshot(path, APP_KEY)
    except (OSError, ValueError, KeyError) as e:
        return [f"<unreadable: {e!r}>"] + sorted(set().union(*expected))
    on_device = {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in leaves.items()}
    got = data.fingerprints(on_device)
    bad: set = set()
    for fp in expected:
        bad.update(check.mismatched(fp, got))
    return sorted(bad)


def training_check(cell: Cell, seed: int, program: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    adamw = cell.config["run"]["adamw"]
    weights = cell.weights(seed, device)
    ref = cell.reference.train_readings(
        weights, [b.to(device) for b in program["batches"]],
        cell.dims, lr=adamw["lr"], betas=adamw["betas"],
        eps=adamw["eps"], weight_decay=adamw["weight_decay"], keep_first_grads=True,
    )
    return check.training_gaps(
        program["losses"], program["grad_norms"], program["change_norms"], ref,
        program["first_moments"], program["first_scale"],
    )


def decide(
    cell: Cell, seed: int, results: List[RankResult], device: torch.device
) -> Tuple[bool, Dict[str, Dict[str, float]], int, List[str]]:
    """``correct``, each compared number with its limit, the operations
    whose answer did not verify, and notes for standard error."""
    limits = cell.config["limits"]
    r0 = results[0]
    notes: List[str] = []
    failed = 0
    gaps = training_check(cell, seed, r0.checks["program"], device)
    notes.append(
        f"training: worst gradient leaf {gaps['grad_leaf']}, worst change leaf {gaps['change_leaf']}, "
        f"worst first-gradient difference leaf {gaps['diff_leaf']}, "
        f"left out of the change {gaps['left_out']}"
    )
    save_bad = 0
    for i, s in enumerate(r0.saves):
        bad = check_saved(s["path"], [r.saves[i]["fp"] for r in results], device)
        if bad:
            failed += 1
            save_bad += len(bad)
            notes.append(f"save {i} (step {s['step']}): {len(bad)} leaves differ, e.g. {bad[:5]}")
    expected_saves = len(cell.traffic["marks"]) if cell.traffic["loop"] == "save" else 0
    restore_bad = 0
    if cell.traffic["loop"] == "restart":
        path, expected = r0.checks["setup_save"]
        bad = check_saved(path, [expected], device)
        save_bad += len(bad)
        if bad:
            notes.append(f"the saved state: {len(bad)} leaves differ, e.g. {bad[:5]}")
        for r in results:
            for i, leaves, n in r.checks["restore_mismatched"]:
                failed += 1
                restore_bad += n
                notes.append(f"rank {r.rank} restore {i}: {n} leaves differ, e.g. {leaves}")
    expected_restores = len(cell.traffic["marks"]) if cell.traffic["loop"] == "restart" else 0
    notes.append(
        f"window: {r0.window_s:.3f} s, steps {[len(r.steps) for r in results]}, "
        f"saves {[round(s['call_s'], 4) for s in r0.saves]}, restores {[round(r['s'], 4) for r in r0.restores]}"
    )
    missing = sum(
        abs(len(r.saves) - expected_saves) + abs(len(r.restores) - expected_restores) for r in results
    )
    # A configuration's limits name the training numbers it compares: one
    # with no upper reading on the chip is not compared (PERF.md).
    compared = {name: {"value": gaps[name], "limit": limit} for name, limit in limits.items()}
    compared.update({
        "saved_leaves_differing": {"value": save_bad, "limit": 0},
        "restored_leaves_differing": {"value": restore_bad, "limit": 0},
        "operations_missing": {"value": missing, "limit": 0},
    })
    correct = all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values()
    )
    return correct, compared, failed, notes


# ----------------------------------------------------------------------
# the whole run
# ----------------------------------------------------------------------


def assemble(cell: Cell, results: List[RankResult]) -> Dict[str, Any]:
    """The record the per-layer readers read."""
    d = cell.dims
    r0 = results[0]
    saves = []
    for i, s in enumerate(r0.saves):
        calls = [r.saves[i]["call_s"] for r in results]
        saves.append({"call_s": max(calls), "calls_s": calls, "committed_s": s.get("committed_s")})
    return {
        "cell": cell.name, "loop": cell.traffic["loop"], "mode": cell.traffic.get("mode", "sync"),
        "chips": cell.chips, "ranks": len(results), "window_s": r0.window_s,
        "steps": r0.steps, "step_counts": [len(r.steps) for r in results],
        "tokens_per_step": d.batch * d.seq, "flops_per_step": cell.arch.step_flops(d),
        "peak_flops": PEAK_BF16_FLOPS,
        # Each kernel's bound also under its own key, as flash_chunk_roofline reads it.
        **{f"{k.name}_bound_s": k.bound_s for k in cell.arch.kernels(d)},
        "saves": saves, "restores": [{"s": r["s"]} for r in r0.restores],
        "counters": [r.counters for r in results], "histograms": [r.histograms for r in results],
        "traces": [r.trace for r in results],
    }


def end_to_end(cell: Cell, rec: Dict[str, Any], setup_s: float) -> Dict[str, float]:
    """The cell's end-to-end metrics. A quantity split by cells, such as
    ``tokens_per_s.restart``, is read as the quantity before its first dot."""
    tokens = sum(rec["step_counts"]) * rec["tokens_per_step"]
    values = {"tokens_per_s": tokens / rec["window_s"], "setup_s": setup_s}
    out = {}
    for m in cell.end_to_end:
        base = m.name.split(".")[0]
        if base in values:
            out[m.name] = values[base]
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(
    bench_root: str, cell_name: str, seed: int, seconds: float, trace: bool, rank: int,
    world: int, port: int, root: str, init: Optional[Callable[[], Any]],
) -> None:
    """A rank other than 0, in its own process."""
    import sys

    from .spec import load_cell

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    wrap = init() if init is not None else None
    cell = load_cell(bench_root, cell_name)
    os.environ.update(cell.config["run"].get("knobs", {}))
    device = _rank_device(rank)
    _init_group(rank, world, port)
    ctl = DistControl()
    try:
        res = run_rank(cell, seed, seconds, trace, device, ctl, root, wrap)
        res.forbidden = forbidden_modules()
        ctl.gather(res)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _rank_device(rank: int) -> torch.device:
    if torch.cuda.is_available():
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    return torch.device("cpu")


def _init_group(rank: int, world: int, port: int) -> None:
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
    )


def run_cell(
    bench_root: str, cell: Cell, seed: int, seconds: float, trace: bool,
    init: Optional[Callable[[], Any]] = None,
) -> Tuple[Dict[str, Any], RankResult, List[RankResult], bool, Dict[str, Any], int, List[str]]:
    """Run every rank of ``cell``; returns the readers' record, rank 0's and
    every rank's result, ``correct``, the compared numbers, the failed
    operations and notes. ``init`` (a module-level function, run first in
    every rank) may return a wrapper of the program's train step."""
    world = cell.ranks
    wrap = init() if init is not None else None
    device = _rank_device(0)
    root = tempfile.mkdtemp(prefix="portbench-")
    procs: List[Any] = []
    try:
        if world == 1:
            results = [run_rank(cell, seed, seconds, trace, device, Control(), root, wrap)]
        else:
            port = free_port()
            ctx = multiprocessing.get_context("spawn")
            procs = [
                ctx.Process(
                    target=_child,
                    args=(bench_root, cell.name, seed, seconds, trace, r, world, port, root, init),
                )
                for r in range(1, world)
            ]
            for p in procs:
                p.start()
            _init_group(0, world, port)
            ctl = DistControl()
            try:
                mine = run_rank(cell, seed, seconds, trace, device, ctl, root, wrap)
                results = ctl.gather(mine)
            finally:
                import torch.distributed as dist

                dist.destroy_process_group()
        rec = assemble(cell, results)
        correct, compared, failed, notes = decide(cell, seed, results, device)
        return rec, results[0], results, correct, compared, failed, notes
    finally:
        for p in procs:
            p.join(CHILD_JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)


def reckoned_written_bytes(cell: Cell) -> int:
    """The state's bytes once a save: the warm-up save and each window save."""
    saves = 1 + (len(cell.traffic["marks"]) if cell.traffic["loop"] == "save" else 0)
    return saves * cell.arch.state_bytes(cell.dims)
