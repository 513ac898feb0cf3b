"""fsck of the port: the shallow existence and length audit, the deep CRC
audit, incremental chains audited through their refs, per-chunk checks,
the CLI's exit codes; and both packages' fsck on each other's snapshots.

Ports of the 13 cases of the JAX package's ``tests/test_fsck.py``, plus
the cross-package audit: each package's ``verify_snapshot`` passes a
snapshot the other wrote at ``deep=True``, and a planted missing blob,
truncation or bit flip gives the same problem kind in both. The tiered
and peer audits are refused (ROADMAP queue 1 step 9).
"""

import os
import subprocess
import sys

import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.fsck import verify_snapshot as jax_verify
from torchsnapshot_tpu.tricks.torch import TorchStateful
from torchsnapshot_tpu_torch import Snapshot, StateDict, TensorTreeState, fsck
from torchsnapshot_tpu_torch.fsck import main as fsck_main, verify_snapshot
from torchsnapshot_tpu_torch.knobs import disable_checksums, override_max_chunk_size_bytes

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _take(tmp_path, name="snap"):
    state = {
        "m": TensorTreeState(
            {
                "w": torch.arange(256, dtype=torch.float32).reshape(16, 16),
                "b": torch.arange(8, dtype=torch.int32),
            }
        ),
        "meta": StateDict(step=7, blob={10, 20}),  # an opaque pickled leaf
    }
    p = str(tmp_path / name)
    Snapshot.take(p, state)
    return p


def _flip(blob: str, offset: int) -> None:
    with open(blob, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_sound_snapshot_passes_both_levels(tmp_path) -> None:
    p = _take(tmp_path)
    shallow = verify_snapshot(p)
    assert shallow.ok and shallow.blobs_checked >= 3
    deep = verify_snapshot(p, deep=True)
    assert deep.ok and deep.bytes_verified > 0


def test_missing_blob_detected(tmp_path) -> None:
    p = _take(tmp_path)
    os.remove(os.path.join(p, "0", "m", "w"))
    report = verify_snapshot(p)
    assert not report.ok
    assert any(pr.kind == "missing" and pr.location == "0/m/w" for pr in report.problems)


def test_truncated_blob_detected_shallow(tmp_path) -> None:
    p = _take(tmp_path)
    with open(os.path.join(p, "0", "m", "w"), "r+b") as f:
        f.truncate(100)  # the manifest implies 1024 bytes
    report = verify_snapshot(p)
    assert not report.ok
    assert any(pr.kind == "truncated" for pr in report.problems)


def test_bitrot_detected_deep_only(tmp_path) -> None:
    p = _take(tmp_path)
    _flip(os.path.join(p, "0", "m", "w"), 64)
    assert verify_snapshot(p).ok  # same length: shallow cannot see it
    deep = verify_snapshot(p, deep=True)
    assert not deep.ok
    assert any(pr.kind == "checksum" for pr in deep.problems)


def test_uncommitted_directory_fails(tmp_path) -> None:
    p = _take(tmp_path)
    os.remove(os.path.join(p, ".snapshot_metadata"))
    report = verify_snapshot(p)
    assert not report.ok
    assert report.problems[0].kind == "missing"


def test_incremental_chain_audited_through_refs(tmp_path) -> None:
    state = {"m": TensorTreeState({"w": torch.arange(64, dtype=torch.float32)})}
    p0, p1 = str(tmp_path / "s0"), str(tmp_path / "s1")
    Snapshot.take(p0, state, record_digests=True)
    Snapshot.take(p1, state, incremental_base=p0)
    assert verify_snapshot(p1, deep=True).ok
    # Destroy the base blob: the incremental snapshot's audit fails even
    # though its own directory is untouched.
    os.remove(os.path.join(p0, "0", "m", "w"))
    report = verify_snapshot(p1)
    assert not report.ok
    assert any(pr.location == "../s0/0/m/w" for pr in report.problems)


def test_chunked_entries_checked_per_chunk(tmp_path) -> None:
    with override_max_chunk_size_bytes(256):
        big = torch.arange(32 * 8, dtype=torch.float32).reshape(32, 8)
        p = str(tmp_path / "snap")
        Snapshot.take(p, {"m": TensorTreeState({"big": big})})
    report = verify_snapshot(p, deep=True)
    assert report.ok and report.blobs_checked >= 4
    chunks = [f for f in os.listdir(os.path.join(p, "0", "m")) if f.startswith("big")]
    os.remove(os.path.join(p, "0", "m", sorted(chunks)[1]))
    assert not verify_snapshot(p).ok


def test_cli_exit_codes(tmp_path, capsys) -> None:
    p = _take(tmp_path)
    assert fsck_main([p]) == 0
    assert "OK (shallow)" in capsys.readouterr().out
    assert fsck_main([p, "--deep"]) == 0
    assert "OK (deep)" in capsys.readouterr().out
    os.remove(os.path.join(p, "0", "m", "w"))
    assert fsck_main([p]) == 1
    out = capsys.readouterr().out
    assert "FSCK missing: 0/m/w" in out and "FAILED" in out


def test_deep_streams_across_chunk_boundaries(tmp_path, monkeypatch) -> None:
    """The deep CRC chains across ranged-read chunks (bounded memory); a
    flip in the second chunk is still caught."""
    monkeypatch.setattr(fsck, "_DEEP_CHUNK_BYTES", 256)
    p = _take(tmp_path)  # w is 1024 bytes: 4 chunks
    assert verify_snapshot(p, deep=True).ok
    _flip(os.path.join(p, "0", "m", "w"), 700)
    deep = verify_snapshot(p, deep=True)
    assert not deep.ok
    assert any(pr.kind == "checksum" for pr in deep.problems)


def test_deep_counts_crc_verified_blobs(tmp_path) -> None:
    p = _take(tmp_path)
    report = verify_snapshot(p, deep=True)
    assert report.crcs_verified == report.blobs_checked
    assert report.bytes_verified > 0


def test_deep_without_tables_is_visibly_hollow(tmp_path, capsys) -> None:
    with disable_checksums():
        p = _take(tmp_path, name="nocrc")
        report = verify_snapshot(p, deep=True)
        assert report.ok and report.crcs_verified == 0
        assert fsck_main([p, "--deep"]) == 0
        assert "WARNING: 0 blobs CRC-verified" in capsys.readouterr().out


def test_shallow_transient_error_is_unreadable_not_truncated(tmp_path, monkeypatch) -> None:
    """A non-OSError storage failure is reported as 'unreadable'
    (retryable), never as snapshot damage."""
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    p = _take(tmp_path)
    orig = FSStoragePlugin.read

    async def flaky(self, read_io):
        if read_io.path == "0/m/w":
            raise RuntimeError("injected transient storage error")
        return await orig(self, read_io)

    monkeypatch.setattr(FSStoragePlugin, "read", flaky)
    report = verify_snapshot(p)
    assert not report.ok
    [prob] = [pr for pr in report.problems if pr.location == "0/m/w"]
    assert prob.kind == "unreadable"


def test_memory_store_truncation_detected_shallow() -> None:
    """A plugin that slices past EOF silently (the in-memory store) still
    surfaces truncation through the read-length check."""
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

    url = "memory://fsck-trunc-port"
    try:
        Snapshot.take(url, {"m": TensorTreeState({"w": torch.arange(16, dtype=torch.float32)})})
        plugin = MemoryStoragePlugin(name="fsck-trunc-port")
        blob = plugin._blobs["0/m/w"]
        plugin._blobs["0/m/w"] = blob[: len(blob) // 2]
        report = verify_snapshot(url)
        assert not report.ok
        assert any(pr.kind == "truncated" for pr in report.problems)
    finally:
        MemoryStoragePlugin.drop_store("fsck-trunc-port")


def test_module_runs_as_a_program(tmp_path) -> None:
    p = _take(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    run = subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch.fsck", p, "--deep"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=120,
    )
    assert run.returncode == 0, run.stderr
    assert "OK (deep)" in run.stdout


@pytest.mark.parametrize("tier", ["fast", "durable", "peer"])
def test_tier_audits_refused(tmp_path, tier) -> None:
    """The per-tier audits of a ``tiered://`` snapshot are ported; only
    the peer-placement audit still raises, naming its step. A tier of a
    plain path is a caller's error, as in the JAX package."""
    from torchsnapshot_tpu_torch.tiered import reset_mirror, wait_durable

    if tier == "peer":
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 step 9b-ii"):
            verify_snapshot(_take(tmp_path), tier=tier)
        return
    with pytest.raises(ValueError, match="requires a tiered:// path"):
        verify_snapshot(_take(tmp_path), tier=tier)
    url = f"tiered://{tmp_path / 'fast'}|{tmp_path / 'durable'}"
    reset_mirror()
    try:
        Snapshot.take(url, {"model": _module()})
        wait_durable(url, timeout=60)
    finally:
        reset_mirror()
    report = verify_snapshot(url, deep=True, tier=tier)
    assert report.ok and report.crcs_verified == report.blobs_checked > 0
    os.remove(os.path.join(tmp_path, tier, "0", "model", "0.weight"))
    damaged = verify_snapshot(url, tier=tier)
    assert [p.kind for p in damaged.problems] == ["missing"]
    assert verify_snapshot(url).ok  # the composed view reads the other tier


# ---------------------------------------------------------------------------
# both packages' fsck on each other's snapshots
# ---------------------------------------------------------------------------


def _module():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.Linear(64, 8))


def _take_with(package: str, path: str, module) -> None:
    if package == "port":
        Snapshot.take(path, {"model": module})
    else:
        jts.Snapshot.take(path, {"model": TorchStateful(module)})


def _plant(path: str, fault: str) -> str:
    blob = os.path.join(path, "0", "model", "0.weight")
    if fault == "missing":
        os.remove(blob)
    elif fault == "truncated":
        with open(blob, "r+b") as f:
            f.truncate(100)
    else:
        _flip(blob, 1000)
    return "0/model/0.weight"


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("fault", [None, "missing", "truncated", "checksum"])
def test_both_fscks_agree_on_either_package_snapshot(tmp_path, writer, fault) -> None:
    path = str(tmp_path / "snap")
    _take_with(writer, path, _module())
    location = _plant(path, fault) if fault else None
    port, jax = verify_snapshot(path, deep=True), jax_verify(path, deep=True)
    assert port.blobs_checked == jax.blobs_checked > 0
    if fault is None:
        assert port.ok and jax.ok
        assert port.crcs_verified == jax.crcs_verified == port.blobs_checked
        assert port.bytes_verified == jax.bytes_verified
        return
    got = {(p.kind, p.location) for p in port.problems}
    assert got == {(p.kind, p.location) for p in jax.problems} == {(fault, location)}


def test_incremental_chain_across_packages_audited_by_both(tmp_path) -> None:
    module = _module()
    p0, p1 = str(tmp_path / "s0"), str(tmp_path / "s1")
    jts.Snapshot.take(p0, {"model": TorchStateful(module)}, record_digests=True)
    with torch.no_grad():
        module[1].bias.add_(1.0)
    Snapshot.take(p1, {"model": module}, incremental_base=p0)
    assert verify_snapshot(p1, deep=True).ok and jax_verify(p1, deep=True).ok
    _flip(os.path.join(p0, "0", "model", "0.weight"), 8)
    for report in (verify_snapshot(p1, deep=True), jax_verify(p1, deep=True)):
        assert [(p.kind, p.location) for p in report.problems] == [
            ("checksum", "../s0/0/model/0.weight")
        ]
