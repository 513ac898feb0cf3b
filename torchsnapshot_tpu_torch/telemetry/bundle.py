"""Incident black-box bundles: the evidence, frozen at the moment it
mattered.

Copy of ``torchsnapshot_tpu/telemetry/bundle.py``, in the same layout and
manifest schema: either package's ``load_manifest``, doctor and SLO engine
read a bundle the other captured.

Every diagnostic artifact the stack records lives next to a live
snapshot root — which preemption, retention GC, or a cleanup job may
destroy before anyone investigates. ``capture_bundle`` assembles a
bounded, self-contained incident directory the moment something goes
wrong (an SLO breach, a watchdog stall episode, a failed op) so the
post-mortem reads the run as it was, not as whatever survived.

A bundle deliberately MIMICS a snapshot directory's on-disk layout —
the ledger tail as ``.ledger.jsonl``, the step-history tail, the
triggering snapshot's SnapshotReports as ``.telemetry.jsonl``, its
Chrome traces and heartbeat files under their original basenames, the
tuner decision state — plus a ``manifest.json`` carrying the trigger,
an env fingerprint, the effective knob/tunable vector, and the
capture-time doctor verdicts. Because the layout IS a snapshot dir,
the entire offline analysis stack works against a bundle unchanged:
``doctor --bundle <path>``, ``telemetry slo <path>``, ``telemetry
trace <path>``, ``telemetry goodput <path>`` and ``diff <bundleA>
<bundleB>`` all reproduce the live run's answers from a relocated copy
with the original root gone (pinned by test).

Captures are edge-triggered by their callers (one per breach episode /
stall episode), rate-limited per bundle dir, and size-capped: artifact
copies stop once the byte budget is spent, with JSONL tails truncated
newest-last so the budget buys the most recent evidence. A
non-positive ``TORCHSNAPSHOT_TPU_BUNDLE_MAX_BYTES`` disables capture
entirely (the test conftest pins it so). Best-effort throughout: a
failed capture logs and returns None, never fails the op that
triggered it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import platform
import shutil
import socket
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .. import knobs
from .wire import FLEET_ENDPOINT_BASENAME

logger = logging.getLogger(__name__)

BUNDLE_DIR_BASENAME = ".bundles"
MANIFEST_BASENAME = "manifest.json"
BUNDLE_VERSION = 1

# Rate-limit state per bundle dir (monotonic stamp of the last capture
# attempt that passed the gate). Process-local, lock-guarded: the
# watchdog thread and async-save commit threads both trigger.
_LOCK = threading.Lock()
_LAST_CAPTURE: Dict[str, float] = {}


def reset_bundle_state() -> None:
    """Drop the rate-limit stamps (tests)."""
    with _LOCK:
        _LAST_CAPTURE.clear()


def bundle_root_for(root: str) -> Optional[str]:
    """Where a root's bundles land: the knob'd dir, else ``.bundles``
    on the root's local tier (a tiered root's fast tier — the bundle
    must survive remote-tier cleanup)."""
    configured = knobs.get_bundle_dir()
    if configured:
        return configured
    from .sink import local_fs_root

    local = local_fs_root(root)
    if local is None and "://" not in root:
        local = root
    if local is None:
        return None
    return os.path.join(local, BUNDLE_DIR_BASENAME)


def is_bundle(path: str) -> bool:
    """True when ``path`` is a captured bundle dir (has a manifest)."""
    return os.path.isfile(os.path.join(path, MANIFEST_BASENAME))


def load_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The bundle's manifest, or None when unreadable/absent."""
    try:
        with open(os.path.join(path, MANIFEST_BASENAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def list_bundles(root: str) -> List[Dict[str, Any]]:
    """Captured bundles for a root (or of a bundle dir's parent),
    oldest first: ``{path, trigger, reason, unix_ts, bytes, files}``
    per bundle, from each manifest."""
    candidates: List[str] = []
    if is_bundle(root):
        candidates = [root]
    else:
        broot = root if os.path.basename(root) == BUNDLE_DIR_BASENAME else None
        if broot is None:
            broot = bundle_root_for(root)
        if broot is not None and os.path.isdir(broot):
            candidates = sorted(
                os.path.join(broot, name) for name in os.listdir(broot)
            )
    out: List[Dict[str, Any]] = []
    for path in candidates:
        manifest = load_manifest(path)
        if manifest is None:
            continue
        out.append(
            {
                "path": path,
                "trigger": manifest.get("trigger"),
                "reason": manifest.get("reason"),
                "unix_ts": manifest.get("unix_ts"),
                "bytes": manifest.get("bytes"),
                "files": len(manifest.get("files", [])),
            }
        )
    out.sort(key=lambda b: b.get("unix_ts") or 0)
    return out


def default_capture_root() -> Optional[str]:
    """The root a rootless trigger (the stall watchdog) captures for:
    the first manager root this process opened a run ledger at — owning
    the ledger is what makes this process that root's rank 0."""
    from . import ledger

    owned = ledger.owned_roots()
    if not owned:
        return None
    return os.path.dirname(owned[0])


def _latest_snapshot_path(root: str) -> Optional[str]:
    """The newest snapshot dir under a manager root that recorded
    reports — the op the incident evidence should center on."""
    from .sink import SNAPSHOT_EVENTS_BASENAME, local_fs_root

    local = local_fs_root(root)
    if local is None and "://" not in root:
        local = root
    if local is None or not os.path.isdir(local):
        return None
    best: Optional[Tuple[float, str]] = None
    for name in os.listdir(local):
        events = os.path.join(local, name, SNAPSHOT_EVENTS_BASENAME)
        try:
            mtime = os.path.getmtime(events)
        except OSError:
            continue
        if best is None or mtime > best[0]:
            best = (mtime, os.path.join(local, name))
    return best[1] if best else None


def _copy_file(
    src: str, dest_dir: str, name: str, remaining: int
) -> Optional[Dict[str, Any]]:
    """Whole-file copy within budget; skipped (None) when it would not
    fit. Atomic enough for a bundle: the bundle dir itself is built
    under a ``.tmp`` name and renamed once complete."""
    try:
        size = os.path.getsize(src)
        if size > remaining:
            return None
        shutil.copyfile(src, os.path.join(dest_dir, name))
        return {"name": name, "bytes": size, "truncated": False}
    except OSError as e:
        logger.warning("bundle: could not copy %r: %r", src, e)
        return None


def _copy_jsonl_tail(
    src: str, dest_dir: str, name: str, remaining: int
) -> Optional[Dict[str, Any]]:
    """JSONL copy that truncates to the newest lines fitting the
    budget — the tail is where the incident is."""
    try:
        size = os.path.getsize(src)
        if size <= remaining:
            return _copy_file(src, dest_dir, name, remaining)
        if remaining <= 0:
            return None
        with open(src, errors="replace") as f:
            lines = f.readlines()
        kept: List[str] = []
        budget = remaining
        for line in reversed(lines):
            nbytes = len(line.encode("utf-8"))
            if nbytes > budget:
                break
            kept.append(line)
            budget -= nbytes
        if not kept:
            return None
        kept.reverse()
        dest = os.path.join(dest_dir, name)
        with open(dest, "w") as f:
            f.writelines(kept)
        return {
            "name": name,
            "bytes": os.path.getsize(dest),
            "truncated": True,
        }
    except OSError as e:
        logger.warning("bundle: could not tail-copy %r: %r", src, e)
        return None


def _env_fingerprint() -> Dict[str, Any]:
    return {
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
    }


def _knob_env() -> Dict[str, str]:
    """The operator-set knob surface verbatim — what made THIS run
    behave the way the evidence shows."""
    return {
        k: v
        for k, v in sorted(os.environ.items())
        if k.startswith("TORCHSNAPSHOT_TPU_")
    }


def capture_bundle(
    root: str,
    trigger: str,
    reason: str = "",
    step: Optional[int] = None,
    snapshot_path: Optional[str] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Optional[str]:
    """Freeze the root's diagnostic evidence into one bounded bundle
    dir; returns its path, or None when capture is disabled, gated by
    the rate limit, or nothing could be assembled. Never raises."""
    try:
        return _capture(root, trigger, reason, step, snapshot_path, extra)
    except Exception as e:  # noqa: BLE001 - must never fail the trigger
        logger.warning("bundle: capture for %r failed: %r", root, e)
        return None


def _capture(
    root: str,
    trigger: str,
    reason: str,
    step: Optional[int],
    snapshot_path: Optional[str],
    extra: Optional[Dict[str, Any]],
) -> Optional[str]:
    max_bytes = knobs.get_bundle_max_bytes()
    if max_bytes <= 0:
        return None
    from .ledger import step_from_path

    # A step dir handed in as the root (the failed-op trigger passes
    # the op's own path): capture at its manager root — the bundle
    # must survive the step's retention GC.
    if step_from_path(root) is not None:
        if snapshot_path is None:
            snapshot_path = root
        root = os.path.dirname(root.rstrip("/")) or root
    bundle_root = bundle_root_for(root)
    if bundle_root is None:
        return None
    min_interval = knobs.get_bundle_min_interval_seconds()
    now = time.monotonic()
    with _LOCK:
        last = _LAST_CAPTURE.get(bundle_root)
        if (
            min_interval > 0
            and last is not None
            and now - last < min_interval
        ):
            return None
        # Stamp before the (slow) assembly so a concurrent trigger
        # does not start a second capture of the same incident.
        _LAST_CAPTURE[bundle_root] = now

    from .history import HISTORY_BASENAME, history_path_for
    from .ledger import LEDGER_BASENAME, find_ledger_for
    from .progress import find_progress_files
    from .sink import SNAPSHOT_EVENTS_BASENAME, local_fs_root
    from .stats import find_events_for
    from .trace import find_trace_files

    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    name = f"bundle-{trigger}-{stamp}-{os.getpid()}"
    dest = os.path.join(bundle_root, name)
    if os.path.exists(dest):  # same trigger, same second, same pid
        dest = f"{dest}-{int(time.time() * 1000) % 1000:03d}"
    tmp = dest + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    files: List[Dict[str, Any]] = []
    remaining = max_bytes

    def add(entry: Optional[Dict[str, Any]]) -> None:
        nonlocal remaining
        if entry is not None:
            files.append(entry)
            remaining -= entry["bytes"]

    # Priority order: the budget buys the run-level story first (the
    # ledger and history tails), then the triggering op's own records.
    ledger_file = find_ledger_for(root)
    if ledger_file is not None:
        add(_copy_jsonl_tail(ledger_file, tmp, LEDGER_BASENAME, remaining))
    hist_path = history_path_for(root)
    if hist_path is not None and os.path.exists(hist_path):
        add(_copy_jsonl_tail(hist_path, tmp, HISTORY_BASENAME, remaining))

    if snapshot_path is None:
        snapshot_path = _latest_snapshot_path(root)
    if snapshot_path is not None:
        reports = find_events_for(snapshot_path)
        if reports and remaining > 0:
            lines = [json.dumps(r, sort_keys=True) + "\n" for r in reports]
            kept: List[str] = []
            budget = remaining
            for line in reversed(lines):
                nbytes = len(line.encode("utf-8"))
                if nbytes > budget:
                    break
                kept.append(line)
                budget -= nbytes
            if kept:
                kept.reverse()
                dest_path = os.path.join(tmp, SNAPSHOT_EVENTS_BASENAME)
                with open(dest_path, "w") as f:
                    f.writelines(kept)
                add(
                    {
                        "name": SNAPSHOT_EVENTS_BASENAME,
                        "bytes": os.path.getsize(dest_path),
                        "truncated": len(kept) < len(lines),
                    }
                )
        for trace_path in find_trace_files(snapshot_path):
            base = os.path.basename(trace_path)
            if not base.startswith("."):
                base = f".trace-{base}"
            add(_copy_file(trace_path, tmp, base, remaining))
        for progress_path in find_progress_files(snapshot_path):
            add(
                _copy_file(
                    progress_path,
                    tmp,
                    os.path.basename(progress_path),
                    remaining,
                )
            )

    local = local_fs_root(root)
    if local is None and "://" not in root:
        local = root
    if local is not None:
        from ..tuner.state import TUNER_STATE_BASENAME

        for aux in (TUNER_STATE_BASENAME, FLEET_ENDPOINT_BASENAME):
            aux_path = os.path.join(local, aux)
            if os.path.exists(aux_path):
                add(_copy_file(aux_path, tmp, aux, remaining))

    # Capture-time doctor verdicts: what the live rules said with every
    # signal still on disk — the baseline an offline re-diagnosis of
    # this bundle is compared against.
    verdicts: List[Dict[str, Any]] = []
    try:
        from .doctor import diagnose_snapshot

        target = snapshot_path if snapshot_path is not None else root
        verdicts = [v.to_dict() for v in diagnose_snapshot(target)]
    except Exception as e:  # noqa: BLE001
        logger.warning("bundle: capture-time diagnosis failed: %r", e)

    mirror_state: Optional[Dict[str, Any]] = None
    try:
        from ..tiered.mirror import mirror_state_for_path

        mirror_state = mirror_state_for_path(snapshot_path or root)
    except Exception:  # noqa: BLE001
        mirror_state = None

    manifest = {
        "version": BUNDLE_VERSION,
        "trigger": trigger,
        "reason": reason,
        "step": step,
        "root": root,
        "snapshot_path": snapshot_path,
        "unix_ts": round(time.time(), 6),
        "max_bytes": max_bytes,
        "bytes": max_bytes - remaining,
        "env": _env_fingerprint(),
        "knobs": _knob_env(),
        "tunables": knobs.tunable_snapshot(),
        "files": files,
        "verdicts": verdicts,
        "mirror_state": mirror_state,
        "extra": extra or {},
    }
    from .sink import atomic_write_text

    atomic_write_text(
        os.path.join(tmp, MANIFEST_BASENAME),
        json.dumps(manifest, indent=2, sort_keys=True),
    )
    os.rename(tmp, dest)

    from . import metrics
    from . import names

    metrics().counter_inc(names.BUNDLE_CAPTURES_TOTAL, trigger=trigger)
    logger.warning(
        "bundle: captured %s (%s%s, %d files, %d bytes)",
        dest,
        trigger,
        f": {reason}" if reason else "",
        len(files),
        max_bytes - remaining,
    )
    return dest


def render(bundles: List[Dict[str, Any]]) -> str:
    if not bundles:
        return "no bundles captured"
    lines = [
        f"{'captured':<20} {'trigger':<14} {'files':>5} {'bytes':>10} path"
    ]
    for b in bundles:
        ts = b.get("unix_ts")
        when = (
            time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(ts))
            if isinstance(ts, (int, float))
            else "-"
        )
        lines.append(
            f"{when:<20} {str(b.get('trigger')):<14} "
            f"{b.get('files', 0):>5} {b.get('bytes', 0):>10} {b['path']}"
        )
    return "\n".join(lines)


def main(argv: Optional[Iterable[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="torchsnapshot_tpu_torch.telemetry bundle",
        description=(
            "List a root's captured incident bundles, or capture one "
            "now. Analyze a bundle with `telemetry doctor --bundle`, "
            "`telemetry slo`, or `telemetry diff`."
        ),
    )
    parser.add_argument(
        "root", help="manager root, bundle parent dir, or bundle dir"
    )
    parser.add_argument(
        "--capture",
        action="store_true",
        help="capture a bundle for the root now",
    )
    parser.add_argument(
        "--trigger", default="manual", help="trigger label for --capture"
    )
    parser.add_argument(
        "--reason", default="", help="reason line for --capture"
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    args = parser.parse_args(list(argv) if argv is not None else None)
    if args.capture:
        path = capture_bundle(
            args.root, trigger=args.trigger, reason=args.reason
        )
        if path is None:
            print(
                "bundle capture disabled or rate-limited "
                "(TORCHSNAPSHOT_TPU_BUNDLE_MAX_BYTES <= 0 disables it)"
            )
            return 1
        print(path)
        return 0
    bundles = list_bundles(args.root)
    if args.json:
        print(json.dumps(bundles, indent=2, sort_keys=True))
    else:
        print(render(bundles))
    return 0
