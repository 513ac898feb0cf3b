"""The zero-pack vectorized slab write in the port
(``TORCHSNAPSHOT_TPU_WRITE_VECTORIZED``, on by default).

Port of the vectorized cases of the JAX package's
``tests/test_write_path.py``: the slab stage runs no pack pass and emits
its own span; its staging cost is the slab's bytes only; the vectorized
and packed paths write the same blob bytes and CRC entries, with and
without the native runtime and with the device pack; the report records
the write path. Added: the one-pack-is-the-slab shortcut gives way to the
vectorized payload with the knob on, as the JAX package's stage does; the
pack-bytes-avoided counter; and slabs written by both packages with the
knob on are byte-identical, CRC tables included.
"""

import contextlib
import glob
import json
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, _native, knobs, telemetry
from torchsnapshot_tpu_torch.batcher import batch_write_requests
from torchsnapshot_tpu_torch.event_loop import run_in_fresh_event_loop
from torchsnapshot_tpu_torch.io_preparer import DeviceCopier, prepare_write
from torchsnapshot_tpu_torch.io_types import BufferList
from torchsnapshot_tpu_torch.telemetry import names as metric_names
from torchsnapshot_tpu_torch.telemetry.trace import get_recorder

torch.set_num_threads(1)


def _prepare_slab(n_members: int = 6, member_floats: int = 512):
    rng = np.random.default_rng(3)
    copier = DeviceCopier()
    entries, reqs = [], []
    for i in range(n_members):
        t = torch.from_numpy(rng.standard_normal(member_floats).astype(np.float32))
        entry, wr = prepare_write(t, f"t/{i}", rank=0, copier=copier)
        entries.append(entry)
        reqs.extend(wr)
    entries, batched = batch_write_requests(entries, reqs)
    assert len(batched) == 1
    return entries, batched[0]


def test_vectorized_slab_stage_runs_no_pack_pass(monkeypatch) -> None:
    """On the vectorized path the slab stage hands the member buffers on
    untouched: no slab buffer, no ``gather_memcpy``, no
    ``batcher:stage_slab`` span; the vectorized span instead."""
    calls = {"aligned": 0, "gather": 0}
    real_aligned, real_gather = _native.aligned_buffer, _native.gather_memcpy

    def aligned(*a, **k):
        calls["aligned"] += 1
        return real_aligned(*a, **k)

    def gather(*a, **k):
        calls["gather"] += 1
        return real_gather(*a, **k)

    monkeypatch.setattr(_native, "aligned_buffer", aligned)
    monkeypatch.setattr(_native, "gather_memcpy", gather)
    with knobs.override_slab_size_threshold_bytes(1 << 20), knobs.enable_write_vectorized():
        _, req = _prepare_slab()
        mark = get_recorder().mark()
        buf = run_in_fresh_event_loop(req.buffer_stager.stage_buffer())
    assert isinstance(buf, BufferList) and len(buf.parts) == 6
    assert calls == {"aligned": 0, "gather": 0}
    names = {ev.get("name") for ev in get_recorder().events_since(mark)}
    assert metric_names.SPAN_BATCHER_STAGE_SLAB_VECTORIZED in names
    assert metric_names.SPAN_BATCHER_STAGE_SLAB not in names

    # The packed path (knob off) still packs, and says so on the ring.
    with knobs.override_slab_size_threshold_bytes(1 << 20), knobs.disable_write_vectorized():
        _, req = _prepare_slab()
        mark = get_recorder().mark()
        packed = run_in_fresh_event_loop(req.buffer_stager.stage_buffer())
    assert not isinstance(packed, BufferList)
    assert calls["aligned"] == 1
    names = {ev.get("name") for ev in get_recorder().events_since(mark)}
    assert metric_names.SPAN_BATCHER_STAGE_SLAB in names
    assert bytes(packed) == bytes(buf.consolidate())


def test_vectorized_staging_cost_is_total_only() -> None:
    with knobs.override_slab_size_threshold_bytes(1 << 20):
        with knobs.enable_write_vectorized():
            _, req = _prepare_slab()
            vec_cost = req.buffer_stager.get_staging_cost_bytes()
            total = req.buffer_stager.total
        with knobs.disable_write_vectorized():
            _, req = _prepare_slab()
            packed_cost = req.buffer_stager.get_staging_cost_bytes()
    assert vec_cost == total
    assert packed_cost > vec_cost  # slab + peak member on the packed path


def test_vectorized_is_on_by_default_and_pinned_at_construction() -> None:
    """The default is on; a knob flip after construction changes neither
    the cost nor the payload the stager was admitted for."""
    assert knobs.is_write_vectorized_enabled()
    with knobs.override_slab_size_threshold_bytes(1 << 20):
        _, req = _prepare_slab()
        cost = req.buffer_stager.get_staging_cost_bytes()
        with knobs.disable_write_vectorized():
            buf = run_in_fresh_event_loop(req.buffer_stager.stage_buffer())
    assert isinstance(buf, BufferList) and cost == req.buffer_stager.total


def test_vectorized_stage_refuses_a_member_of_the_wrong_size() -> None:
    with knobs.override_slab_size_threshold_bytes(1 << 20), knobs.enable_write_vectorized():
        _, req = _prepare_slab(n_members=3)
        stager = req.buffer_stager
        victim = stager.members[1][0].buffer_stager
        victim.tensor = victim.tensor[:-1]
        with pytest.raises(RuntimeError, match="planned at"):
            run_in_fresh_event_loop(stager.stage_buffer())


# ---------------------------------------------------------------------------
# end-to-end byte identity
# ---------------------------------------------------------------------------


def _arrays(n: int, floats: int) -> dict:
    rng = np.random.default_rng(11)
    return {f"a{i}": rng.standard_normal(floats).astype(np.float32) for i in range(n)}


def _slab(path: str):
    [slab] = glob.glob(os.path.join(path, "batched", "*"))
    with open(os.path.join(path, "checksums", "0")) as f:
        table = json.load(f)
    [entry] = [v for k, v in table.items() if k.startswith("batched/")]
    with open(slab, "rb") as f:
        return f.read(), entry


def _take_batched(path: str, vectorized: bool, n: int, floats: int, pack: bool = False):
    arrays = _arrays(n, floats)
    ctxs = [
        knobs.enable_batching(),
        knobs.override_slab_size_threshold_bytes(32 << 20),
        knobs.enable_write_vectorized() if vectorized else knobs.disable_write_vectorized(),
    ]
    if pack:
        ctxs.append(knobs.enable_device_pack())
    with contextlib.ExitStack() as stack:
        for c in ctxs:
            stack.enter_context(c)
        Snapshot.take(path, {"s": TensorTreeState({k: torch.from_numpy(v) for k, v in arrays.items()})})
        dest = TensorTreeState({k: torch.zeros(floats) for k in arrays})
        Snapshot(path).restore({"s": dest})
    for k, v in arrays.items():
        assert np.array_equal(dest.tree[k].numpy(), v), k
    return _slab(path)


SLAB_CASES = [(8, 1000), (3, (2 << 20) // 4)]  # many members; pages straddle members


@pytest.mark.parametrize("pack", [False, True], ids=["per-member", "device-pack"])
@pytest.mark.parametrize("n,floats", SLAB_CASES)
def test_vectorized_and_packed_bit_identical(tmp_path, n, floats, pack) -> None:
    vec = _take_batched(str(tmp_path / "vec"), True, n, floats, pack)
    packed = _take_batched(str(tmp_path / "packed"), False, n, floats, pack)
    assert vec == packed


def test_vectorized_fallback_without_native_still_zero_pack(tmp_path) -> None:
    """No native runtime: the fs plugin writes the parts one by one into
    one file (still no consolidation), the scheduler computes the
    checksum over the parts, and the bytes match the native path."""
    vec_bytes, vec_entry = _take_batched(str(tmp_path / "nat"), True, 5, 800)
    calls = []
    real = BufferList.consolidate

    def spy(self):
        calls.append(len(self))
        return real(self)

    BufferList.consolidate = spy
    try:
        with knobs.disable_native():
            fb_bytes, fb_entry = _take_batched(str(tmp_path / "fallback"), True, 5, 800)
    finally:
        BufferList.consolidate = real
    assert fb_bytes == vec_bytes
    assert calls == []
    # The algorithm may differ (crc32 vs crc32c) without the runtime.
    assert fb_entry[2] == vec_entry[2]


def _avoided() -> float:
    return telemetry.metrics().counters_snapshot().get(metric_names.BATCHER_PACK_BYTES_AVOIDED_TOTAL, 0.0)


@pytest.mark.parametrize("pack", [False, True], ids=["per-member", "device-pack"])
def test_report_records_write_path_variant(tmp_path, pack) -> None:
    """The report's ``write_path`` names the vectorized variant for the
    slab's bytes; with the device pack, one pack holding the whole slab
    is cut into parts rather than written as the slab (the JAX stage's
    choice on the same plan), and with the knob off it is the slab."""
    path = str(tmp_path / "snap")
    before = _avoided()
    _take_batched(path, True, 6, 1000, pack)
    rep = telemetry.last_report("take", path=path)
    assert rep is not None and rep.write_path is not None
    assert "write_path" in rep.to_dict()
    after = _avoided()
    assert after - before == 6 * 1000 * 4
    if _native.lib() is not None:
        assert rep.write_path.get("vectorized") == 6 * 1000 * 4
    off = str(tmp_path / "off")
    _take_batched(off, False, 6, 1000, pack)
    rep_off = telemetry.last_report("take", path=off)
    assert "vectorized" not in (rep_off.write_path or {})
    assert _avoided() == after


# ---------------------------------------------------------------------------
# the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pack", [False, True], ids=["per-member", "device-pack"])
@pytest.mark.parametrize("n,floats", SLAB_CASES)
def test_vectorized_slabs_and_crc_tables_equal_the_jax_package(tmp_path, n, floats, pack) -> None:
    """The same batched state, taken by both packages with the knob on:
    the slab bytes, the slab's CRC entry and the whole CRC table are the
    same, and both reports name the vectorized write path."""
    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu import knobs as jknobs
    from torchsnapshot_tpu import telemetry as jtelemetry

    port = _take_batched(str(tmp_path / "port"), True, n, floats, pack)
    jpath = str(tmp_path / "jax")
    arrays = _arrays(n, floats)
    jctx = jknobs.enable_device_pack() if pack else contextlib.nullcontext()
    if pack:
        # The JAX package packs device arrays: the same plan reaches its
        # pack group, cut into parts as the port's is.
        import jax.numpy as jnp

        arrays = {k: jnp.asarray(v) for k, v in arrays.items()}
    with jknobs.enable_batching(), jknobs.override_slab_size_threshold_bytes(32 << 20), \
            jknobs.enable_write_vectorized(), jctx:
        jts.Snapshot.take(jpath, {"s": jts.PyTreeState(arrays)})
    assert _slab(jpath) == port

    def table(path):
        with open(os.path.join(path, "checksums", "0")) as f:
            return {("slab" if k.startswith("batched/") else k): v for k, v in json.load(f).items()}

    assert table(jpath) == table(str(tmp_path / "port"))
    if _native.lib() is not None:
        jrep = jtelemetry.last_report("take", path=jpath)
        prep = telemetry.last_report("take", path=str(tmp_path / "port"))
        assert "vectorized" in jrep.write_path and "vectorized" in prep.write_path
        assert jrep.write_path["vectorized"] == prep.write_path["vectorized"]
