"""The rest of a run, at a tiny size on the CPU, with the timed path broken
underneath: ``correct`` has to come out false for each fault a cell can
have, and true with none. Each ``fault_*`` runs first in every rank's
process (module-level, so that spawned ranks can run it) and may return a
wrapper of the program's train step."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

from harness.cell import run_cell
from harness.spec import load_cell


def fault_none():
    return None


def fault_state_unchanged():
    """A step that computes its loss and returns the state as it was."""
    import torch
    from torchsnapshot_tpu_torch.models.transformer import loss_fn

    def wrap(step):
        def unchanged(state, tokens):
            with torch.no_grad():
                return state, loss_fn(state.model, tokens)

        return unchanged

    return wrap


def fault_half_batch():
    """Half of the batch left out, the mean taken over the rest."""

    def wrap(step):
        return lambda state, tokens: step(state, tokens[: tokens.shape[0] // 2])

    return wrap


def _rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def fault_exchange_left_out():
    """The partition's exchange lost: the replicated blobs that ranks other
    than 0 were given to write never reach storage."""
    from torchsnapshot_tpu_torch.storage_plugins import fs

    write, fused = fs.FSStoragePlugin.write, fs.FSStoragePlugin.write_with_checksum

    def dropped(io):
        return _rank() != 0 and io.path.startswith("replicated/")

    async def write_(self, io):
        if not dropped(io):
            await write(self, io)

    async def fused_(self, io):
        return None if dropped(io) else await fused(self, io)

    fs.FSStoragePlugin.write, fs.FSStoragePlugin.write_with_checksum = write_, fused_


def _flip_one_byte(step_dir):
    files = [
        os.path.join(d, f) for d, _, fs_ in os.walk(step_dir) for f in fs_
        if "/params/" in os.path.join(d, f).replace(os.sep, "/")
    ]
    path = max(files, key=os.path.getsize)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x10]))


def fault_saved_byte_altered():
    """One byte of a parameter's blob altered where the save produced it."""
    from torchsnapshot_tpu_torch import manager

    save, wait = manager.CheckpointManager.save, manager._PendingManagedSnapshot.wait

    def save_(self, step, app_state, **kw):
        out = save(self, step, app_state, **kw)
        if _rank() == 0:
            _flip_one_byte(self.step_path(step))
        return out

    def wait_(self, phase="committed"):
        out = wait(self, phase)
        if phase == "committed":
            _flip_one_byte(self._manager.step_path(self._step))
        return out

    manager.CheckpointManager.save, manager._PendingManagedSnapshot.wait = save_, wait_


def fault_restored_leaf_altered():
    """One element of a restored parameter altered where the restore produced it."""
    import torch
    from torchsnapshot_tpu_torch import manager

    restore = manager.CheckpointManager.restore_latest

    def restore_(self, app_state):
        out = restore(self, app_state)
        with torch.no_grad():
            app_state["train"].model.unembed.view(-1)[7] += 1
        return out

    manager.CheckpointManager.restore_latest = restore_


@pytest.fixture(autouse=True)
def unpatched():
    """Rank 0 runs in this process: put back what a fault patched."""
    from torchsnapshot_tpu_torch import manager
    from torchsnapshot_tpu_torch.storage_plugins import fs

    saved = [
        (manager.CheckpointManager, "save"), (manager.CheckpointManager, "restore_latest"),
        (manager._PendingManagedSnapshot, "wait"), (fs.FSStoragePlugin, "write"),
        (fs.FSStoragePlugin, "write_with_checksum"),
    ]
    before = [(cls, name, cls.__dict__[name]) for cls, name in saved]
    yield
    for cls, name, attr in before:
        setattr(cls, name, attr)


CASES = [
    ("pythia-160m.sync_save", fault_none, True),
    ("pythia-160m.async_save", fault_none, True),
    ("pythia-410m.restart", fault_none, True),
    ("pythia-160m.sync_save", fault_state_unchanged, False),
    ("pythia-160m.sync_save", fault_half_batch, False),
    ("pythia-410m.restart", fault_half_batch, False),
    ("pythia-160m.sync_save", fault_saved_byte_altered, False),
    ("pythia-160m.async_save", fault_saved_byte_altered, False),
    ("pythia-410m.restart", fault_restored_leaf_altered, False),
]


@pytest.mark.parametrize("cell, fault, sound", CASES, ids=lambda x: getattr(x, "__name__", str(x)))
def test_one_rank(tiny_root, cell, fault, sound):
    c = load_cell(tiny_root, cell)
    _, _, _, correct, compared, _, _ = run_cell(tiny_root, c, 2**31 + 17, 1.0, False, init=fault)
    assert correct is sound, compared


@pytest.mark.parametrize("fault, sound", [
    (fault_none, True), (fault_exchange_left_out, False), (fault_saved_byte_altered, False),
], ids=lambda x: getattr(x, "__name__", str(x)))
def test_four_ranks(tiny_root, fault, sound):
    """In a fresh process each: the port caches its process group per process."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = {[here, os.path.dirname(here), os.path.dirname(os.path.dirname(here))]!r}
        from harness.cell import run_cell
        from harness.spec import load_cell
        import test_portbench_faults as t
        cell = load_cell({tiny_root!r}, "pythia-160m.ddp4_sync_save")
        out = run_cell({tiny_root!r}, cell, 2**33 + 5, 1.0, False, init=getattr(t, {fault.__name__!r}))
        print("RESULT", len(out[2]), out[3], out[4])
    """)
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900)
    lines = [l for l in done.stdout.splitlines() if l.startswith("RESULT")]
    assert done.returncode == 0 and lines, done.stderr[-3000:]
    _, ranks, correct, compared = lines[-1].split(" ", 3)
    assert ranks == "4"
    assert correct == str(sound), compared
