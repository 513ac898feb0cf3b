"""The port's LFM2-MoE (``torchsnapshot_tpu_torch/models/lfm2.py``) against
the benchmark's plain reference (``portbench/reference/lfm2.py``), on
seeded weights at the adapter's tiny size (``portbench/archs/lfm2.py``
``tiny``: width 64, heads 4 and 2 of 16, one dense and three sparse
layers, 4 of 8 experts held, top-2).

On the CPU the program runs in float32 against the float32 reference:
the same mathematics summed in another order (the flash blocks against
explicit scores, grouped expert products against per-expert gathers, the
conv's shifts against ``F.conv1d``), so the tolerances sit a few orders of
magnitude above float32's rounding of these sums and far below any
change of the mathematics (a dropped term, a wrong tap or head moves a
reading by 1e-2 or more). The ``cuda_only`` tests run on a card; this file
imports no jax, so they run there with ``--noconftest``.
"""

import ast
import dataclasses
import json
import os
import sys
from pathlib import Path

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "portbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness.data import make_weights  # noqa: E402
from harness.spec import load_arch  # noqa: E402
from reference import lfm2 as ref  # noqa: E402

from torchsnapshot_tpu_torch import telemetry  # noqa: E402
from torchsnapshot_tpu_torch.models import lfm2  # noqa: E402
from torchsnapshot_tpu_torch.ops import short_conv as sc  # noqa: E402
from torchsnapshot_tpu_torch.telemetry import names  # noqa: E402

SEED = 2**33 + 7


def _arch_and_dims(dtype="float32", **overrides):
    with open(os.path.join(BENCH, "configs", "lfm2-8b-a1b.json")) as f:
        cfg = json.load(f)
    arch = load_arch(BENCH, cfg)
    cfg = arch.tiny(cfg)
    cfg["run"]["dtype"] = dtype
    cfg.update(overrides)
    return arch, arch.dims(cfg), cfg["run"]


def _weights(arch, d, seed=SEED, bias_scale=0.0, device="cpu"):
    """The benchmark's draw in bfloat16 (float32 expert biases), as every
    cell draws it; ``bias_scale`` > 0 replaces the zero biases by seeded
    normals of that scale."""
    w = make_weights(arch.leaf_shapes(d), "bfloat16", seed, torch.device(device))
    g = torch.Generator().manual_seed(seed % 2**31)
    for k in w:
        if k.endswith("expert_bias") and bias_scale:
            w[k] = (bias_scale * torch.randn(w[k].shape, generator=g)).to(device)
    return w


def _program(arch, d, run, weights, device="cpu"):
    """The program's state with ``weights`` loaded, its step and leaves."""
    state, step, params_of = arch.build(d, run, 0, device)
    with torch.no_grad():
        for name, t in params_of(state).items():
            t.copy_(weights[name])
    return state, step, params_of


def _tokens(d, seed=SEED, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed % 2**31)
    return torch.randint(0, d.vocab, (d.batch, d.seq), generator=g, device=device)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


# ----------------------------------------------------------------------
# the program against the reference
# ----------------------------------------------------------------------


@pytest.mark.parametrize("bias_scale", [0.0, 0.5])
def test_forward_logits_match_the_reference(bias_scale):
    """Logits of both sequences, float32: within 1e-5 of the reference's
    largest (measured: under 2e-6)."""
    arch, d, run = _arch_and_dims()
    w = _weights(arch, d, bias_scale=bias_scale)
    state, _, _ = _program(arch, d, run, w)
    tokens = _tokens(d)
    with torch.no_grad():
        got = state.model(tokens)
        p = {k: v.float() for k, v in w.items()}
        want = torch.stack([ref.row_logits(p, row, d, "f32") for row in tokens])
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("bias_scale", [0.0, 0.5])
def test_one_training_step_matches_the_reference(bias_scale):
    """One step of the program (float32 state) against ``train_readings``
    from the same bfloat16-drawn weights: the loss within 1e-6 relative,
    every trained leaf's gradient within 1e-4 of its norm (measured: under
    2e-6), and AdamW's change of every leaf, the program's new value
    rounded to bfloat16 as the reference stores it, within 2e-3 of the
    reference's change norm (elements whose two float32 values straddle a
    bfloat16 rounding boundary land one ulp apart). The frozen biases are
    read and left unchanged."""
    arch, d, run = _arch_and_dims()
    w = _weights(arch, d, bias_scale=bias_scale)
    adamw = run["adamw"]
    state, step, params_of = _program(arch, d, run, w)
    tokens = _tokens(d)
    _, loss = step(state, tokens)
    r = ref.train_readings(w, [tokens], d, lr=adamw["lr"], betas=adamw["betas"], eps=adamw["eps"],
                           weight_decay=adamw["weight_decay"], keep_first_grads=True)
    assert abs(float(loss) - r.losses[0]) <= 1e-6 * r.losses[0]
    leaves = params_of(state)
    assert sorted(r.first_grads) == sorted(k for k in leaves if not k.endswith("expert_bias"))
    for name, want in r.first_grads.items():
        assert _rel(leaves[name].grad, want) <= 1e-4, name
        change = (leaves[name].detach().to(torch.bfloat16).float() - w[name].float()).norm()
        assert abs(float(change) - r.change_norms[name]) <= 2e-3 * r.change_norms[name], name
    for name, t in leaves.items():
        if name.endswith("expert_bias"):
            assert t.dtype == torch.float32 and torch.equal(t, w[name])


def test_the_expert_shares_add_up_to_the_whole_layer():
    """8 experts over 4 shares of 2: each share's sparse layer (the program's
    ``sparse_ffn``, told which experts it holds, given their stacks) adds up
    to the uncut reference's whole layer, within float32's sums (1e-5 of
    its largest)."""
    arch, d, _ = _arch_and_dims(num_experts=8)
    w = {k: v.float() for k, v in _weights(arch, d, bias_scale=0.5).items()}
    blk = "layers/1/"
    layer = {k[len(blk):]: v for k, v in w.items() if k.startswith(blk)}
    h = torch.randn(d.batch, d.seq, d.d_model, generator=torch.Generator().manual_seed(5))
    whole = ref.held_experts(h.reshape(-1, d.d_model), w, blk, d, torch.matmul).view_as(h)
    total = torch.zeros_like(h)
    for share in range(4):
        cfg = lfm2.Lfm2Config(d_model=d.d_model, n_heads=d.n_heads, n_kv_heads=d.n_kv_heads,
                              layer_types=d.layer_types, n_dense_layers=d.n_dense, moe_d_ff=d.moe_d_ff,
                              n_experts=8, top_k=d.top_k, experts_held=range(2 * share, 2 * share + 2),
                              dtype=torch.float32)
        part = dict(layer, **{n: layer[n][2 * share:2 * share + 2] for n in ("w1", "w3", "w2")})
        counts = lfm2.MoeCounters.begin(torch.device("cpu"))
        total += lfm2.sparse_ffn(cfg, part, h, counts)
        assert int(counts[0] + counts[1]) == d.batch * d.seq * d.top_k
    assert (total - whole).abs().max() <= 1e-5 * whole.abs().max()


@pytest.mark.parametrize("bias_scale", [0.0, 0.5, 5.0])
def test_routing_with_an_expert_bias_matches_the_reference(bias_scale):
    """The chosen experts (as sets) and their weights, with the bias zero,
    comparable to the scores, and large enough to decide alone."""
    arch, d, _ = _arch_and_dims()
    w = {k: v.float() for k, v in _weights(arch, d, bias_scale=bias_scale).items()}
    blk = "layers/2/"
    layer = {k[len(blk):]: v for k, v in w.items() if k.startswith(blk)}
    x = torch.randn(256, d.d_model, generator=torch.Generator().manual_seed(6))
    cfg = lfm2.Lfm2Config(n_experts=d.n_experts, top_k=d.top_k, experts_held=range(0, d.experts_held))
    got_e, got_w = lfm2.route(cfg, layer, x)
    want_e, want_w = ref.route(x, layer["router"], layer["expert_bias"], d.top_k, torch.matmul)
    got_e, order = got_e.sort(dim=1)
    want_e, want_order = want_e.sort(dim=1)
    assert torch.equal(got_e, want_e)
    assert (got_w.gather(1, order) - want_w.gather(1, want_order)).abs().max() <= 1e-6
    if bias_scale == 5.0:  # the bias alone decides
        top = layer["expert_bias"].topk(d.top_k).indices.sort().values
        assert (got_e == top).all()


@pytest.mark.parametrize("seq", [128, 384])
def test_rope_qk_norm_and_gqa_attention_alone(seq):
    """The attention mixer against the reference's: 4 query heads over 2 KV
    heads, QK-norm scales away from one, RoPE at base 1e6, over one and
    three of the flash path's 128-position blocks; float32 within 1e-5 of
    the largest output."""
    arch, d, _ = _arch_and_dims()
    d = dataclasses.replace(d, seq=seq)
    w = {k: v.float() for k, v in _weights(arch, d).items()}
    blk = "layers/1/"
    g = torch.Generator().manual_seed(8)
    w[blk + "q_norm"] = 1 + 0.3 * torch.randn(d.head_dim, generator=g)
    w[blk + "k_norm"] = 1 + 0.3 * torch.randn(d.head_dim, generator=g)
    layer = {k[len(blk):]: v for k, v in w.items() if k.startswith(blk)}
    cfg = lfm2.Lfm2Config(d_model=d.d_model, n_heads=d.n_heads, n_kv_heads=d.n_kv_heads,
                          layer_types=d.layer_types, dtype=torch.float32)
    h = torch.randn(d.batch, d.seq, d.d_model, generator=g)
    rope = lfm2.rope_tables(d.seq, d.head_dim, cfg.rope_theta, h.device)
    got = lfm2.attention_mixer(cfg, layer, h, rope)
    want = torch.stack([ref.attention(row, w, blk, d, torch.matmul) for row in h])
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_make_weights_draws_the_same_weights_for_program_and_reference(dtype):
    """The adapter's leaves are the program's (names, shapes, dtypes, the
    float32 frozen biases among them); one draw loads into the program bit
    for bit; and the adapter counts the program's state."""
    arch, d, run = _arch_and_dims(dtype)
    w = make_weights(arch.leaf_shapes(d), dtype, SEED, torch.device("cpu"))
    state, _, params_of = _program(arch, d, run, w)
    leaves = params_of(state)
    assert {k: (tuple(t.shape), t.dtype) for k, t in leaves.items()} == {
        k: (tuple(t.shape), t.dtype) for k, t in w.items()
    }
    assert all(torch.equal(leaves[k], w[k]) for k in w)
    assert [k for k in leaves if k.endswith("expert_bias")] == [f"layers/{i}/expert_bias" for i in (1, 2, 3)]
    params = list(state.model.parameters())
    buffers = [t for k, t in leaves.items() if k.endswith("expert_bias")]
    assert arch.param_count(d) == sum(p.numel() for p in params)
    assert arch.leaf_count(d) == 3 * len(params) + len(buffers)
    assert arch.state_bytes(d) == 3 * sum(p.numel() * p.element_size() for p in params) + sum(
        b.numel() * 4 for b in buffers)


def test_the_configuration_at_its_published_widths():
    """The cell's own configuration: 12 layers (9 conv, 3 attention), 8 of
    32 experts held, 1,286,316,416 trained parameters, 361 card tensors, a
    7.718 GB state; every width as published."""
    with open(os.path.join(BENCH, "configs", "lfm2-8b-a1b.json")) as f:
        cfg = json.load(f)
    arch = load_arch(BENCH, cfg)
    d = arch.dims(cfg)
    assert d.layer_types == tuple(cfg["published"]["layer_types"][:12])
    assert (d.d_model, d.n_heads, d.n_kv_heads, d.head_dim, d.d_ff, d.moe_d_ff) == (2048, 32, 8, 64, 7168, 1792)
    assert (d.n_experts, d.experts_held, d.top_k, d.vocab) == (32, 8, 4, 65536)
    assert arch.param_count(d) == 1_286_316_416
    assert arch.leaf_count(d) == 361
    assert arch.state_bytes(d) == 3 * 1_286_316_416 * 2 + 10 * 32 * 4
    assert sorted(cfg["reduced"]) == ["layer_types", "num_experts", "num_hidden_layers"]


# ----------------------------------------------------------------------
# the short convolution's plain versions
# ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 37, 16), (1, 3, 8), (3, 1, 24)])
def test_short_conv_plain_versions_match_the_reference_and_autograd(shape):
    """``short_conv_plain`` against the reference's ``F.conv1d``, and
    ``short_conv_bwd_plain`` against autograd of the reference, float32,
    within 1e-5 of the largest (sequences shorter than the taps included)."""
    b, s, d = shape
    g = torch.Generator().manual_seed(s)
    p = torch.randn(b, s, 3 * d, generator=g, requires_grad=True)
    w = torch.randn(3, d, generator=g, requires_grad=True)
    eye = torch.eye(3 * d)
    want = torch.stack([ref.short_conv(row, eye, w, torch.matmul) for row in p])
    assert (sc.short_conv_plain(p, w) - want).abs().max() <= 1e-5 * want.abs().max()
    dy = torch.randn(b, s, d, generator=g)
    want_dp, want_dw = torch.autograd.grad(want, (p, w), dy)
    dp, dw = sc.short_conv_bwd_plain(p.detach(), w.detach(), dy)
    assert (dp - want_dp).abs().max() <= 1e-5 * want_dp.abs().max()
    assert (dw - want_dw).abs().max() <= 1e-5 * want_dw.abs().max()
    got_dp, got_dw = torch.autograd.grad(sc.gated_short_conv(p, w), (p, w), dy)
    assert torch.equal(got_dp, dp) and torch.equal(got_dw, dw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_short_conv_routes_cpu_tensors_to_the_plain_versions_and_its_kernel_entries_refuse_them(dtype):
    """Off the card ``gated_short_conv`` is the plain version, bf16 too; the
    kernels' entries take card tensors only and raise, never falling back."""
    g = torch.Generator().manual_seed(7)
    p = torch.randn(2, 9, 3 * 16, generator=g).to(dtype)
    w = torch.randn(3, 16, generator=g).to(dtype)
    before = dict(sc.launch_counts)
    assert torch.equal(sc.gated_short_conv(p, w), sc.short_conv_plain(p, w))
    with pytest.raises(ValueError, match="ts_short_conv_fwd takes"):
        sc.short_conv_fwd(p, w)
    with pytest.raises(ValueError, match="ts_short_conv_bwd takes"):
        sc.short_conv_bwd(p, w, torch.zeros(2, 9, 16, dtype=dtype))
    assert sc.launch_counts == before


# ----------------------------------------------------------------------
# routing counters
# ----------------------------------------------------------------------


def _moe_counters():
    dump = telemetry.metrics().collect()["counters"]
    return {k: v for k, v in dump.items() if k.startswith("moe_")}


def test_the_steps_counters_reach_the_registry_one_step_late(monkeypatch):
    """Step n's routing counts are added by step n + 1: held and absent
    assignments add up to every top-k assignment of the sparse layers, and
    the held ones and each layer's most-loaded held expert are those of
    the experts the step's router chose."""
    telemetry.reset_metrics()
    arch, d, run = _arch_and_dims()
    state, step, _ = _program(arch, d, run, _weights(arch, d, bias_scale=0.5))
    chosen = []
    route = lfm2.route

    def recording(cfg, layer, x):
        experts, weights = route(cfg, layer, x)
        chosen.append(experts.clone())
        return experts, weights

    monkeypatch.setattr(lfm2, "route", recording)
    step(state, _tokens(d))
    assert _moe_counters() == {}
    assert len(chosen) == d.n_layers - d.n_dense
    held = [e[e < d.experts_held] for e in chosen]
    step(state, _tokens(d, seed=SEED + 1))
    total = len(held) * d.batch * d.seq * d.top_k
    n_held = sum(h.numel() for h in held)
    top = sum(int(torch.bincount(h, minlength=d.experts_held).max()) for h in held)
    assert _moe_counters() == {
        'moe_assignments_total{held="1"}': n_held,
        'moe_assignments_total{held="0"}': total - n_held,
        "moe_held_max_tokens_total": top,
        "moe_held_max_tokens_scaled_total": top * d.experts_held,
    }
    telemetry.reset_metrics()


class _Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


def test_publishing_never_waits_for_an_unfinished_copy():
    """A step's counts whose copy's event has not finished stay pending, and
    so do the later steps' behind them; they are added, oldest first, once
    the query says done."""
    telemetry.reset_metrics()
    counters = lfm2.MoeCounters()
    first, second = _Event(False), _Event(True)
    counters._pending.extend([(first, torch.tensor([3, 5, 2, 16])), (second, torch.tensor([1, 1, 1, 8]))])
    assert counters.publish() == 0 and _moe_counters() == {}
    first.done = True
    assert counters.publish() == 2
    assert _moe_counters() == {
        'moe_assignments_total{held="1"}': 4.0,
        'moe_assignments_total{held="0"}': 6.0,
        "moe_held_max_tokens_total": 3.0,
        "moe_held_max_tokens_scaled_total": 24.0,
    }
    telemetry.reset_metrics()


# ----------------------------------------------------------------------
# the checkpoint path
# ----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["save", "async_save"])
def test_a_train_state_round_trips_through_the_manager(tmp_path, mode):
    """An LFM2 train state after two steps (3-D expert stacks, AdamW's
    moments, the float32 frozen biases set away from zero) through
    ``CheckpointManager.save`` or ``async_save``, then ``restore_latest``
    into a state built from another seed: every leaf bit for bit."""
    from torchsnapshot_tpu_torch.manager import CheckpointManager

    arch, d, run = _arch_and_dims("bfloat16")
    state, step, params_of = _program(arch, d, run, _weights(arch, d, bias_scale=0.5))
    for _ in range(2):
        step(state, _tokens(d))
    saved = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in _flat(state.state_dict()).items()}
    assert saved["params/layers/1/w1"].dim() == 3 and saved["params/layers/1/expert_bias"].dtype == torch.float32
    manager = CheckpointManager(str(tmp_path / "root"), keep_last_n=2)
    if mode == "save":
        manager.save(state.step, {"train": state})
    else:
        manager.async_save(state.step, {"train": state}).wait()
    other, _, _ = arch.build(d, run, 99, "cpu")
    assert not torch.equal(params_of(other)["layers/1/expert_bias"], saved["params/layers/1/expert_bias"])
    manager.restore_latest({"train": other})
    got = _flat(other.state_dict())
    assert sorted(got) == sorted(saved)
    for k, want in saved.items():
        if isinstance(want, torch.Tensor):
            assert got[k].dtype == want.dtype and torch.equal(
                got[k].reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)), k
        else:
            assert got[k] == want, k


def _flat(tree, prefix=""):
    from harness.data import flatten

    return flatten(tree, prefix)


# ----------------------------------------------------------------------
# the cell
# ----------------------------------------------------------------------


# The tiny run's own limit on ``grad_diff``: at width 64 the program reads
# 0.22-0.24 and the reversed-taps reference 1.48-1.55 (two seeds each). The
# configuration compares no ``grad_diff``: at the published widths routing
# flips under bf16 set it (0.38), with no upper reading 3x above.
TINY_GRAD_DIFF = 0.6


@pytest.mark.parametrize("fault", [None, "taps reversed"])
def test_the_cells_tiny_run(tmp_path, fault):
    """The cell at the tiny size (``portbench/tests/tinybench.py``) runs
    ``correct`` under ``TINY_GRAD_DIFF``, and its routing readers read
    numbers (about 50% held: 4 of 8 experts); a reference whose conv taps
    run in reverse order is not correct. At a width of 64 the norm gaps
    read higher than at the published widths (``grad_gap`` 0.011-0.039
    against the configuration's 0.02), so the tiny run compares
    ``grad_diff`` alone."""
    tests = os.path.join(BENCH, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from harness.cell import run_cell
    from harness.spec import load_cell
    from tinybench import make_tiny_root

    root = make_tiny_root(str(tmp_path / "bench"), limits={"grad_diff": TINY_GRAD_DIFF})
    if fault:
        path = os.path.join(root, "portbench", "reference", "lfm2.py")
        src = Path(path).read_text()
        line = "taps.t()[:, None]"
        assert src.count(line) == 1
        Path(path).write_text(src.replace(line, "taps.flip(0).t()[:, None]"))
    cell = load_cell(root, "lfm2-8b-a1b.async_save")
    rec, _, _, correct, compared, _, _ = run_cell(root, cell, 2**31 + 43, 1.0, False)
    if fault:
        assert not correct and compared["grad_diff"]["value"] > compared["grad_diff"]["limit"], compared
        return
    assert correct, compared
    readers = {m.name: m.reader for m in cell.per_layer}
    assert 35 < readers["moe_held_share_pct"](rec) < 65
    assert 1 <= readers["moe_load_imbalance"](rec) < 4
    assert readers["short_conv_roofline"](rec) is None  # no trace


# ----------------------------------------------------------------------
# names
# ----------------------------------------------------------------------


@pytest.mark.parametrize("const, value", [
    ("MOE_ASSIGNMENTS_TOTAL", "moe_assignments_total"),
    ("MOE_HELD_MAX_TOKENS_TOTAL", "moe_held_max_tokens_total"),
    ("MOE_HELD_MAX_TOKENS_SCALED_TOTAL", "moe_held_max_tokens_scaled_total"),
    ("SPAN_LFM2_CONV", "lfm2:conv"), ("SPAN_LFM2_ATTN", "lfm2:attn"), ("SPAN_LFM2_FFN", "lfm2:ffn"),
    ("SPAN_LFM2_MOE", "lfm2:moe"), ("SPAN_LFM2_LOSS", "lfm2:loss"),
])
def test_the_models_counters_and_ranges_are_named_in_the_registry(const, value):
    """Each is declared in ``telemetry/names.py`` and used by the model
    through its constant."""
    assert getattr(names, const) == value
    source = Path(lfm2.__file__).read_text()
    used = {n.attr for n in ast.walk(ast.parse(source)) if isinstance(n, ast.Attribute)}
    assert const in used and repr(value) not in source and f'"{value}"' not in source


# ----------------------------------------------------------------------
# on a card
# ----------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest -m cuda_only tests/test_torch_lfm2.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda_only
@pytest.mark.parametrize("counts", [(5, 0, 17, 3), (16, 16, 16, 16), (0, 0, 0, 40)])
def test_grouped_product_on_the_card_matches_its_plain_version(counts):
    """``torch._grouped_mm`` (bf16) against the loop over groups (f32 from
    the same bf16 inputs) on groups of uneven, equal and empty sizes, with
    rows past the last group: the product and both gradients, on the
    groups' rows, within bf16's rounding of f32 sums (2^-7 of the largest)."""
    device = _card()
    g = torch.Generator(device=device).manual_seed(11)
    rows = sum(counts) + 9
    a = torch.randn(rows, 64, generator=g, device=device).to(torch.bfloat16).requires_grad_(True)
    b = torch.randn(len(counts), 64, 48, generator=g, device=device).to(torch.bfloat16).requires_grad_(True)
    offs = torch.tensor(counts, device=device).cumsum(0).to(torch.int32)
    n = sum(counts)
    out = lfm2.grouped_mm(a, b, offs)
    go = torch.randn(rows, 48, generator=g, device=device).to(torch.bfloat16)
    go[n:] = 0
    da, db = torch.autograd.grad(out, (a, b), go)
    af, bf = a.detach().float().requires_grad_(True), b.detach().float().requires_grad_(True)
    want = lfm2.grouped_mm(af, bf, offs)
    wa, wb = torch.autograd.grad(want, (af, bf), go.float())
    for x, y in ((out[:n], want[:n]), (da[:n], wa[:n]), (db, wb)):
        assert (x.float() - y).abs().max() <= 2**-7 * y.abs().max().clamp_min(1e-6)


@pytest.mark.cuda_only
def test_the_step_makes_no_host_synchronisation(monkeypatch):
    """Three training steps on the card (bf16, the flash and short-conv
    kernels, grouped products) with ``torch.cuda.synchronize`` and a CUDA
    tensor's ``item`` / ``tolist`` patched to fail and CUDA's own
    synchronisation check set to raise; the counts arrive later."""
    device = _card()
    from torchsnapshot_tpu_torch.ops import kernels

    kernels.build(["flash_attention", "short_conv"])
    telemetry.reset_metrics()
    # Heads of 64, as the attention backward kernel takes them.
    arch, d, run = _arch_and_dims("bfloat16", hidden_size=256, num_attention_heads=4, num_key_value_heads=2)
    state, step, _ = _program(arch, d, run, _weights(arch, d, device=device), device=device)
    tokens = _tokens(d, device=device)

    def refuse(*args, **kwargs):
        raise AssertionError("a host synchronisation inside the step")

    item, tolist = torch.Tensor.item, torch.Tensor.tolist
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.Tensor, "item", lambda t: refuse() if t.is_cuda else item(t))
    monkeypatch.setattr(torch.Tensor, "tolist", lambda t: refuse() if t.is_cuda else tolist(t))
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            _, loss = step(state, tokens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        monkeypatch.undo()
    assert sc.launch_counts["short_conv_fwd"] >= 3 * sum(k == "conv" for k in d.layer_types)
    torch.cuda.current_stream(device).synchronize()
    assert torch.isfinite(loss)
    state.model.counters.publish()
    got = _moe_counters()
    total = 3 * (d.n_layers - d.n_dense) * d.batch * d.seq * d.top_k
    assert got['moe_assignments_total{held="1"}'] + got['moe_assignments_total{held="0"}'] == total
    telemetry.reset_metrics()
