"""The yardstick's arithmetic at tiny and at published shapes, the
reduction of a trace through the kernel table, and the readers' rates from
a made-up record."""

from __future__ import annotations

import math
import os

import pytest
import torch

from harness import arith, data
from harness.spec import load_arch, load_cell
from harness.trace import summarize
from tinybench import BENCH, REPO

dense = load_arch(BENCH, {})
TINY = dense.Dims(vocab=512, d_model=64, n_heads=4, n_layers=2, d_ff=256, batch=2, seq=128)


def test_counts_match_the_program_and_the_weights_at_a_tiny_size():
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig, init_train_state

    cfg = TransformerConfig(vocab_size=512, d_model=64, n_heads=4, n_layers=2, d_ff=256)
    state = init_train_state(cfg, device="cpu")
    params = list(state.model.parameters())
    assert dense.param_count(TINY) == sum(p.numel() for p in params)
    assert dense.leaf_count(TINY) == 3 * len(params)
    assert dense.state_bytes(TINY) == 3 * sum(p.numel() * p.element_size() for p in params)
    shapes = dense.leaf_shapes(TINY)
    assert dense.matmul_params(TINY) == sum(
        math.prod(leaf.shape) for k, leaf in shapes.items() if len(leaf.shape) == 2 and k != "embed"
    )
    assert TINY.tokens_per_step == 256


@pytest.mark.parametrize("name, params, leaves, gb, tflop", [
    ("pythia-160m", 162_220_800, 225, 0.973, 14.0),
    ("pythia-410m", 405_062_656, 441, 2.430, 19.85),
])
def test_published_configurations(name, params, leaves, gb, tflop):
    cell = load_cell(REPO, {"pythia-160m": "pythia-160m.sync_save", "pythia-410m": "pythia-410m.restart"}[name])
    d = cell.dims
    assert cell.arch.param_count(d) == params
    assert cell.arch.leaf_count(d) == leaves
    assert round(cell.arch.state_bytes(d) / 1e9, 3) == gb
    assert cell.arch.step_flops(d) / 1e12 == pytest.approx(tflop, abs=0.005)


def test_step_flops_tiny():
    # 6 x matmul parameters x tokens, plus 3 x (2 x 2 b h s^2 hd / 2) a layer
    mm = 2 * (4 * 64 * 64 + 2 * 64 * 256) + 64 * 512
    attn = 3 * (4 * 2 * 4 * 128 * 128 * 16 / 2) * 2
    assert dense.step_flops(TINY) == 6 * mm * 256 + attn


def test_flash_chunk_bound_matches_the_kernel_table():
    # PERF.md's kernel table: bf16 (8, 1024, 16, 64) chunk, bound 0.0254 ms (bytes)
    b, s, h, hd = 8, 1024, 16, 64
    assert arith.flash_chunk_bytes(b, s, h, hd) == 3 * b * s * h * hd * 2 + 4 * b * h * s * (hd + 2)
    assert round(arith.flash_chunk_bound_s(b, s, h, hd) * 1e3, 4) == 0.0254
    # At the cells' s = 2048 it is bound by its operations
    assert arith.flash_chunk_bound_s(8, 2048, 12, 64) == arith.flash_chunk_flops(8, 2048, 12, 64) / arith.PEAK_BF16_FLOPS


@pytest.mark.parametrize("b, h, gflop, bound_ms", [(8, 12, 128.849, 0.13028), (4, 16, 85.899, 0.08685)])
def test_flash_bwd_bound_counts_the_models_work(b, h, gflop, bound_ms):
    # Five b h s^2 d products, 2 operations each, halved by the mask; not
    # the kernel's split terms (206.2 GFLOP at 160M's call).
    s, hd = 2048, 64
    assert arith.flash_bwd_flops(b, s, h, hd) == 5 * b * h * s * s * hd
    assert round(arith.flash_bwd_flops(b, s, h, hd) / 1e9, 3) == gflop
    # q, k, v, o, dO, dq, dk, dv at 2 bytes; m, l at 4
    assert arith.flash_bwd_bytes(b, s, h, hd) == 8 * b * s * h * hd * 2 + 2 * 4 * b * h * s
    # bound by its operations at both cells' calls
    assert arith.flash_bwd_bound_s(b, s, h, hd) == arith.flash_bwd_flops(b, s, h, hd) / arith.PEAK_BF16_FLOPS
    assert round(arith.flash_bwd_bound_s(b, s, h, hd) * 1e3, 5) == bound_ms


def test_kernel_table_sums_several_names_and_counts_one():
    from harness.arch import Kernel

    table = [Kernel("bwd", ("stats_k", "dkv_k", "dq_k"), "dkv_k", 2e-9), Kernel("none", ("absent",), "absent", 1.0)]
    dev = [(0, 1, "stats_k<1>"), (1, 5, "void ns::dkv_k(x)"), (5, 8, "dq_k"), (8, 9, "other"),
           (10, 11, "stats_k<1>"), (11, 15, "void ns::dkv_k(x)"), (15, 18, "dq_k")]
    s = summarize(dev, 0, 20, [], table)
    assert s["kernels"]["bwd"] == {"s": pytest.approx(16e-9), "calls": 2, "bound_s": 2e-9}
    assert s["kernels"]["none"] == {"s": 0.0, "calls": 0, "bound_s": 1.0}
    assert (s["bwd_s"], s["bwd_calls"]) == (s["kernels"]["bwd"]["s"], 2)
    # the rest of the summary is the table's own business
    plain = summarize(dev, 0, 20, [])
    assert plain.pop("kernels") == {}
    assert {k: v for k, v in s.items() if k not in ("kernels", "bwd_s", "bwd_calls", "none_s", "none_calls")} == plain
    # the dense table: the backward's three kernels summed, calls by dK/dV
    cell = load_cell(REPO, "pythia-160m.sync_save")
    names = ["(anonymous namespace)::hopper::bwd::flash_bwd_stats_kernel(float const*)",
             "(anonymous namespace)::hopper::bwd::flash_bwd_dkv_kernel(Maps, float2 const*, int)",
             "(anonymous namespace)::hopper::bwd::flash_bwd_dq_kernel(Maps, float2 const*, int)"]
    s = summarize([(10 * i, 10 * i + 10, n) for i, n in enumerate(names)], 0, 30, [], cell.arch.kernels(cell.dims))
    assert s["kernels"]["flash_bwd"]["calls"] == 1 and s["kernels"]["flash_bwd"]["s"] == pytest.approx(30e-9)
    assert s["kernels"]["flash_chunk"]["calls"] == 0


def _load_readers():
    import importlib.util

    readers = {}
    for f in os.listdir(os.path.join(REPO, "portbench", "metrics")):
        spec = importlib.util.spec_from_file_location("m_" + f[:-3], os.path.join(REPO, "portbench", "metrics", f))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        readers[f[:-3]] = mod.read
    return readers


def test_readers_on_a_made_up_record():
    r = _load_readers()
    trace = {"busy_s": 7.5, "window_s": 10.0, "flash_chunk_calls": 100, "flash_chunk_s": 0.02,
             "d2h_s": 0.5, "h2d_s": 0.0,
             "kernels": {"flash_bwd": {"s": 0.05, "calls": 100, "bound_s": 1.3e-4}}}
    rec = {
        "mode": "sync", "ranks": 2, "chips": 2, "window_s": 10.0,
        "steps": [(0.2, "step"), (0.4, "step"), (0.3, "step"), (1.0, "drain")],
        "step_counts": [4, 4], "flops_per_step": 1e12, "peak_flops": 1e15,
        "flash_chunk_bound_s": 5e-5,
        "saves": [{"call_s": 1.0, "committed_s": None}, {"call_s": 2.0, "committed_s": None}],
        "restores": [],
        "counters": [
            {"storage_write_bytes_total{plugin=\"fs\"}": 3e9, "device_to_host_bytes_total": 1e9,
             "coordination_store_seconds_total{op=\"get\"}": 0.2, "coordination_barrier_wait_seconds_total{impl=\"tree\"}": 0.1},
            {"storage_write_bytes_total{plugin=\"fs\"}": 1e9, "device_to_host_bytes_total": 1e9,
             "coordination_store_seconds_total{op=\"get\"}": 0.5},
        ],
        "histograms": [
            {"sum": {"storage_write_seconds{plugin=\"fs\"}": 2.0, "snapshot_phase_seconds{phase=\"staging\"}": 0.6},
             "count": {"storage_write_seconds{plugin=\"fs\"}": 10, "snapshot_phase_seconds{phase=\"staging\"}": 2}},
            {"sum": {"storage_write_seconds{plugin=\"fs\"}": 2.0, "snapshot_phase_seconds{phase=\"staging\"}": 1.0},
             "count": {"storage_write_seconds{plugin=\"fs\"}": 10, "snapshot_phase_seconds{phase=\"staging\"}": 2}},
        ],
        "traces": [trace, trace],
    }
    assert r["write_GBps"](rec) == pytest.approx(1.0)
    assert r["d2h_GBps"](rec) == pytest.approx(2.0)
    assert r["staging_s"](rec) == pytest.approx(0.5)
    assert r["coord_s"](rec) == pytest.approx(0.25)
    assert r["write_share_max_pct"](rec) == pytest.approx(75.0)
    assert r["step_ms_clean"](rec) == pytest.approx(300.0)
    assert r["drain_step_ms"](rec) == pytest.approx(1000.0)
    assert r["train_mfu_pct"](rec) == pytest.approx(100 * 8e12 / (10 * 2 * 1e15))
    assert r["flash_chunk_roofline"](rec) == pytest.approx(25.0)
    assert r["flash_bwd_roofline"](rec) == pytest.approx(26.0)
    assert r["flash_bwd_roofline.restart"](rec) == r["flash_bwd_roofline"](rec)
    assert r["device_idle_pct"](rec) == pytest.approx(25.0)
    # nothing to read: no number, never a 0
    assert r["save_call_ms"](rec) is None and r["commit_s"](rec) is None
    assert r["h2d_GBps"](rec) is None and r["read_GBps"](rec) is None and r["loading_s"](rec) is None
    # a rank whose trace saw no call reads nothing, not 0
    rec["traces"] = [trace, dict(trace, kernels={"flash_bwd": {"s": 0.0, "calls": 0, "bound_s": 1.3e-4}})]
    assert r["flash_bwd_roofline"](rec) == pytest.approx(26.0)
    rec["traces"] = [dict(trace, kernels={})] * 2  # a record without the entry
    assert r["flash_bwd_roofline"](rec) is None and r["flash_chunk_roofline"](rec) == pytest.approx(25.0)
    rec["traces"] = [None, None]
    assert r["flash_chunk_roofline"](rec) is None and r["device_idle_pct"](rec) is None
    assert r["flash_bwd_roofline"](rec) is None


def test_trace_summary_busy_union_and_gap_labels():
    dev = [(0, 10, "k"), (5, 20, "Memcpy DtoH (Device -> Pinned)"), (30, 40,
           "void flash_wgmma_kernel<hopper::Bf16<64>, true, false>(x)")]
    s = summarize(dev, 0, 50, [("step", 0, 25), ("save", 25, 45)], dense.kernels(TINY))
    assert s["busy_s"] == pytest.approx(30e-9)
    assert s["flash_chunk_calls"] == 1 and s["d2h_s"] == pytest.approx(15e-9)
    assert s["idle_gaps"] == [["save", pytest.approx(10e-9)], ["host", pytest.approx(10e-9)]]


def test_fingerprint_sees_one_changed_bit_and_not_the_device():
    t = torch.randn(4097, dtype=torch.bfloat16)
    u = t.clone()
    u.view(torch.int16)[1234] ^= 1
    a, b = data.fingerprints({"x": t}), data.fingerprints({"x": u})
    assert a != b
    assert data.fingerprints({"x": t.float()}) != a  # dtype is part of it
    assert data.fingerprints({"x": t.reshape(17, 241)}) != a  # and shape


def test_make_weights_takes_each_kind_of_leaf():
    from harness.arch import Leaf

    cpu = torch.device("cpu")
    mixed = {"a": Leaf((4, 8), "normal"), "buf": Leaf((3,), "zeros", trained=False, dtype="float32"),
             "s": Leaf((8,), "ones"), "stack": Leaf((2, 8, 4), "normal"), "r": Leaf((8, 2), "normal", dtype="float32")}
    w = data.make_weights(mixed, "bfloat16", 5, cpu)
    assert w["buf"].dtype == torch.float32 and not w["buf"].any()
    assert w["s"].dtype == torch.bfloat16 and bool((w["s"] == 1).all())
    # one draw for the normal leaves, in order, whatever lies between them
    plain = data.make_weights({"a": mixed["a"], "stack": mixed["stack"], "r": Leaf((8, 2), "normal")}, "bfloat16", 5, cpu)
    assert torch.equal(w["a"], plain["a"]) and torch.equal(w["stack"], plain["stack"])
    assert w["r"].dtype == torch.float32 and torch.equal(w["r"], plain["r"].float())
    g = torch.Generator(device=cpu).manual_seed(data.stream_seed(5, data.WEIGHTS))
    flat = torch.empty(32 + 64 + 16, dtype=torch.bfloat16).normal_(generator=g)
    assert torch.equal(w["stack"], flat[32:96].view(2, 8, 4).mul(1 / 8**0.5))  # fan_in = shape[-2]
    with pytest.raises(ValueError, match="init"):
        data.make_weights({"x": Leaf((2, 2), "uniform")}, "bfloat16", 5, cpu)


def test_weights_and_tokens_repeat_from_the_seed():
    big = 2**31 + 987654321
    leaves, cpu = dense.leaf_shapes(TINY), torch.device("cpu")
    w1, w2 = data.make_weights(leaves, "bfloat16", big, cpu), data.make_weights(leaves, "bfloat16", big, cpu)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["embed"], data.make_weights(leaves, "bfloat16", big + 1, cpu)["embed"])
    f1, f2 = data.TokenFeed(TINY, big, torch.device("cpu")), data.TokenFeed(TINY, big, torch.device("cpu"))
    a, b = f1.next(), f2.next()
    assert torch.equal(a, b) and not torch.equal(a, f1.next())
    assert len({tuple(r.tolist()) for r in a}) == a.shape[0]  # rows differ
