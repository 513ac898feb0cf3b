"""The training loss (``torchsnapshot_tpu_torch/ops/cross_entropy.py``) on the
CPU: its plain version against ``F.cross_entropy``, both models' ``loss_fn``
against the loss they computed before it (f32 logits sliced, then
``F.cross_entropy``), the route, and its registry counter.

The kernels of ``csrc/cross_entropy.cu`` run on a card only: their tests are
in ``tests/test_torch_cuda_kernels.py``. Here a stand-in that reports a card
device reaches the kernels' layout checks, which raise before any build.
This file imports no jax.
"""

import ast
import json
import os
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "portbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness.spec import load_arch  # noqa: E402

from torchsnapshot_tpu_torch import telemetry  # noqa: E402
from torchsnapshot_tpu_torch.models import lfm2  # noqa: E402
from torchsnapshot_tpu_torch.models import transformer as tt  # noqa: E402
from torchsnapshot_tpu_torch.ops import cross_entropy as ce  # noqa: E402
from torchsnapshot_tpu_torch.telemetry import names  # noqa: E402

PORT = Path(REPO) / "torchsnapshot_tpu_torch"
SEED = 2**33 + 11


def _logits(rows=48, vocab=200, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn((rows, vocab), generator=g)).to(dtype)
    t = torch.randint(0, vocab, (rows,), generator=g)
    return x, t


def _rows_counted():
    dump = telemetry.metrics().collect()["counters"]
    return {route: dump.get(f'{names.LOSS_ROWS_TOTAL}{{route="{route}"}}', 0.0) for route in ("kernel", "plain")}


# ----------------------------------------------------------------------
# the plain version
# ----------------------------------------------------------------------


@pytest.mark.parametrize("reduction", ce.REDUCTIONS)
def test_plain_version_matches_f_cross_entropy(reduction):
    """f32 logits: the loss and its gradient as ``F.cross_entropy``'s, to
    f32 rounding (log-sum-exp and gather against log-softmax and NLL)."""
    x, t = _logits()
    got_x, want_x = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got = ce.cross_entropy(got_x, t, reduction)
    want = F.cross_entropy(want_x, t, reduction=reduction)
    got.backward()
    want.backward()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(got_x.grad, want_x.grad, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("reduction", ce.REDUCTIONS)
def test_plain_version_gradient_check(reduction):
    """``torch.autograd.gradcheck`` in f64 (the plain version keeps f64),
    and the gradient is the kernel's formula ``(softmax - onehot) / divisor``."""
    x, t = _logits(rows=6, vocab=16, dtype=torch.float64, seed=1)
    x.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda v: ce.cross_entropy_plain(v, t, reduction), (x,))
    (grad,) = torch.autograd.grad(ce.cross_entropy_plain(x, t, reduction), x)
    want = (x.softmax(-1) - F.one_hot(t, x.shape[-1])) / (x.shape[0] if reduction == "mean" else 1)
    torch.testing.assert_close(grad, want, rtol=1e-12, atol=1e-14)


def test_a_bf16_input_gets_its_gradient_in_bf16():
    """bf16 logits on the CPU take the plain version in f32; the gradient
    comes back rounded to bf16 once, as the f32 cast's backward gave it."""
    x, t = _logits(dtype=torch.bfloat16)
    xl = x.clone().requires_grad_(True)
    loss = ce.cross_entropy(xl, t)
    loss.backward()
    xf = x.float().requires_grad_(True)
    F.cross_entropy(xf, t).backward()
    assert loss.dtype == torch.float32 and xl.grad.dtype == torch.bfloat16
    torch.testing.assert_close(loss, F.cross_entropy(x.float(), t), rtol=1e-6, atol=0)
    assert ((xl.grad.float() - xf.grad).abs() <= 2**-8 * xf.grad.abs() + 1e-7).all()


def test_an_unknown_reduction_is_refused():
    x, t = _logits()
    with pytest.raises(ValueError, match="reduction must be one of"):
        ce.cross_entropy(x, t, "none")


# ----------------------------------------------------------------------
# both models' loss_fn against the loss before the fused op
# ----------------------------------------------------------------------


def _tiny(config_file, dtype):
    with open(os.path.join(BENCH, "configs", config_file)) as f:
        cfg = json.load(f)
    arch = load_arch(BENCH, cfg)
    cfg = arch.tiny(cfg)
    cfg["run"]["dtype"] = dtype
    d = arch.dims(cfg)
    state, _, _ = arch.build(d, cfg["run"], SEED % 2**31, "cpu")
    g = torch.Generator().manual_seed(SEED % 2**31)
    tokens = torch.randint(0, d.vocab, (d.batch, d.seq), generator=g)
    return state.model, tokens


def _old_transformer_loss(model, tokens):
    logits = model(tokens)[:, :-1]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))


def _old_lfm2_loss(model, tokens):
    x = model.hidden(tokens)
    logits = (x[:, :-1] @ model.embed.t()).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))


MODELS = {
    "transformer": ("pythia-160m.json", lambda m, t: tt.loss_fn(m, t), _old_transformer_loss),
    "lfm2": ("lfm2-8b-a1b.json", lambda m, t: lfm2.loss_fn(m, t), _old_lfm2_loss),
}


@pytest.mark.parametrize("which", sorted(MODELS))
def test_loss_fn_matches_the_loss_before_the_fused_op(which):
    """f32 at the benchmark adapter's tiny widths: the loss to 1e-6 relative
    and every parameter's gradient to 1e-5 of its largest (f32 rounding of
    the same sums in another order)."""
    config_file, new, old = MODELS[which]
    model, tokens = _tiny(config_file, "float32")
    params = dict(model.named_parameters())
    got = new(model, tokens)
    got_grads = torch.autograd.grad(got, list(params.values()))
    want = old(model, tokens)
    want_grads = torch.autograd.grad(want, list(params.values()))
    assert got.dtype == torch.float32
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-6 * abs(want)
    for name, a, b in zip(params, got_grads, want_grads):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), name


def test_transformer_hidden_is_the_forward_before_the_unembedding():
    model, tokens = _tiny("pythia-160m.json", "float32")
    with torch.no_grad():
        assert torch.equal(model(tokens), (model.hidden(tokens) @ model.unembed).float())


# ----------------------------------------------------------------------
# the route and its counter
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version_and_count_their_rows(dtype):
    x, t = _logits(rows=10, dtype=dtype)
    launches, before = dict(ce.launch_counts), _rows_counted()
    ce.cross_entropy(x, t, "sum")
    after = _rows_counted()
    assert ce.launch_counts == launches
    assert after["plain"] - before["plain"] == 10 and after["kernel"] == before["kernel"]


class _OnCard:
    """A CPU tensor that reports a card device: it reaches the kernels'
    layout checks here, where no card is."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


def _bf16_layout(layout):
    vocab = 60 if layout == "vocab-not-a-multiple-of-8" else 64
    wide, t = _logits(rows=4, vocab=2 * vocab, dtype=torch.bfloat16)
    x = wide[:, :vocab] if layout == "strided" else wide[:, :vocab].contiguous()
    return _OnCard(x), _OnCard(t.clamp(max=vocab - 1))


@pytest.mark.parametrize("layout", ["strided", "vocab-not-a-multiple-of-8"])
def test_a_bf16_card_input_the_kernels_do_not_take_raises(layout):
    """bf16 logits on a card route to the kernels, whose entry raises on a
    layout they do not take: no fallback to the plain version, no launch,
    no rows counted."""
    x, t = _bf16_layout(layout)
    assert ce._on_kernels(x) and not ce.kernel_takes(x, t)
    launches, before = dict(ce.launch_counts), _rows_counted()
    with pytest.raises(ValueError, match="ts_cross_entropy_fwd takes"):
        ce.cross_entropy(x, t)
    assert ce.launch_counts == launches and _rows_counted() == before


def test_the_kernels_take_a_contiguous_bf16_card_input():
    x, t = _bf16_layout("contiguous")
    assert ce._on_kernels(x) and ce.kernel_takes(x, t)
    assert not ce.kernel_takes(x, _OnCard(t._t.int()))  # int64 targets only


def test_f32_card_logits_take_the_plain_version():
    x, _ = _logits(rows=4, vocab=64)
    assert not ce._on_kernels(_OnCard(x))


def test_loss_rows_total_is_declared_once_and_passed_as_the_constant():
    """The series is declared once in ``telemetry/names.py``, and the loss's
    call site passes ``names.LOSS_ROWS_TOTAL`` (the lint of
    ``tests/test_torch_span_names.py`` holds every call site to a constant)."""
    tree = ast.parse((PORT / "telemetry" / "names.py").read_text())
    declared = [
        n for n in ast.walk(tree)
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant) and n.value.value == "loss_rows_total"
    ]
    assert [n.targets[0].id for n in declared] == ["LOSS_ROWS_TOTAL"]
    calls = [
        n for n in ast.walk(ast.parse((PORT / "ops" / "cross_entropy.py").read_text()))
        if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "counter_inc"
    ]
    assert len(calls) == 1 and ast.unparse(calls[0].args[0]) == "names.LOSS_ROWS_TOTAL"
