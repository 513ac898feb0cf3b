"""The configuration's training step in plain PyTorch.

The architecture is the one the configuration file states under ``run``
(``architecture_as_run``): a decoder-only transformer with a token
embedding, blocks of RMSNorm (eps 1e-6) -> fused QKV -> causal softmax
attention -> output projection -> residual, RMSNorm -> up projection ->
tanh GELU -> down projection -> residual, a final RMSNorm and an untied
unembedding, ``y = x @ W`` for every projection; the loss is the mean
next-token cross-entropy over ``tokens[:, 1:]``; AdamW with decoupled
weight decay, its bias corrections as in ``torch.optim.AdamW``.

Storage follows the configuration: parameters and both moments are held
in bfloat16 between steps. Arithmetic is float32 with TF32 off. One
sequence at a time goes through the forward and backward, each row's
summed loss over the whole batch's token count, so that a step of the
full batch fits beside nothing else on the card. ``compute="fp8"`` is the
control: every matrix product's inputs rounded to float8 e4m3 with a
per-tensor scale (as fp8 training scales them), the rest as above.

``follow`` is the steps and AdamW for any architecture's ``row_loss``: a
reference of another architecture (``reference/<name>.py``) gives its own
row loss and reads through it. ``dims`` is the adapter's
(``archs/dense.py``): ``d_model``, ``n_heads`` and ``n_layers`` here.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


@dataclass
class Readings:
    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]
    first_grads: Optional[Dict[str, torch.Tensor]] = None  # float32, on the device


@contextmanager
def _no_tf32() -> Iterator[None]:
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale; the gradient passes
    straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x.detach())


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6) * scale


def row_loss(p: Mapping[str, torch.Tensor], row: torch.Tensor, dims: Any, compute: str) -> torch.Tensor:
    """Summed next-token cross-entropy of one sequence ``row`` (s,)."""
    mm = (lambda a, b: round_fp8(a) @ round_fp8(b)) if compute == "fp8" else (lambda a, b: a @ b)
    s, d, h = row.shape[0], dims.d_model, dims.n_heads
    hd = d // h
    causal = torch.ones(s, s, dtype=torch.bool, device=row.device).tril()
    x = p["embed"][row]
    for i in range(dims.n_layers):
        blk = f"layers/{i}/"
        y = rmsnorm(x, p[blk + "ln1_scale"])
        qkv = mm(y, p[blk + "wqkv"]).view(s, 3, h, hd).permute(1, 2, 0, 3)  # (3, h, s, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        attn = mm(probs, v).transpose(0, 1).reshape(s, d)
        x = x + mm(attn, p[blk + "wo"])
        y = rmsnorm(x, p[blk + "ln2_scale"])
        x = x + mm(F.gelu(mm(y, p[blk + "w_in"]), approximate="tanh"), p[blk + "w_out"])
    logits = mm(rmsnorm(x, p["ln_f_scale"]), p["unembed"])
    return F.cross_entropy(logits[:-1], row[1:], reduction="sum")


def train_readings(
    weights: Mapping[str, torch.Tensor],
    batches: Sequence[torch.Tensor],
    dims: Any,
    lr: float,
    betas: Sequence[float],
    eps: float,
    weight_decay: float,
    compute: str = "f32",
    keep_first_grads: bool = False,
) -> Readings:
    """``follow`` with the dense transformer's ``row_loss``."""
    return follow(row_loss, weights, batches, dims, lr, betas, eps, weight_decay, compute, keep_first_grads)


def follow(
    loss_of_row: Callable[[Mapping[str, torch.Tensor], torch.Tensor, Any, str], torch.Tensor],
    weights: Mapping[str, torch.Tensor],
    batches: Sequence[torch.Tensor],
    dims: Any,
    lr: float,
    betas: Sequence[float],
    eps: float,
    weight_decay: float,
    compute: str = "f32",
    keep_first_grads: bool = False,
) -> Readings:
    """Follow ``len(batches)`` training steps from ``weights`` (bfloat16,
    by parameter path, every one trained): each step's loss, each leaf's
    first gradient norm, and each leaf's change over all the steps; with
    ``keep_first_grads`` the first step's gradients themselves. A leaf the
    loss does not reach has a zero gradient."""
    if compute not in ("f32", "fp8"):
        raise ValueError(compute)
    b1, b2 = betas
    store = torch.bfloat16
    p = {k: w.to(store) for k, w in weights.items()}
    m = {k: torch.zeros_like(w, dtype=store) for k, w in p.items()}
    v = {k: torch.zeros_like(w, dtype=store) for k, w in p.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    first_grads: Optional[Dict[str, torch.Tensor]] = None
    with _no_tf32():
        for t, tokens in enumerate(batches, start=1):
            leaves = {k: w.float().requires_grad_(True) for k, w in p.items()}
            count = tokens.shape[0] * (tokens.shape[1] - 1)
            total = torch.zeros((), dtype=torch.float64, device=tokens.device)
            for row in tokens:
                loss = loss_of_row(leaves, row, dims, compute) / count
                loss.backward()
                total += loss.detach().double()
            losses.append(float(total))
            grads = {k: leaf.grad if leaf.grad is not None else torch.zeros_like(leaf) for k, leaf in leaves.items()}
            if t == 1:
                norms = torch.stack([g.norm() for g in grads.values()]).tolist()
                grad_norms = dict(zip(grads, norms))
                if keep_first_grads:
                    first_grads = {k: g.detach().clone() for k, g in grads.items()}
            with torch.no_grad():
                c1, c2 = 1 - b1 ** t, 1 - b2 ** t
                for k, g in grads.items():
                    mf = m[k].float() * b1 + (1 - b1) * g
                    vf = v[k].float() * b2 + (1 - b2) * g * g
                    pf = leaves[k].detach() * (1 - lr * weight_decay)
                    pf = pf - (lr / c1) * mf / (vf.sqrt() / math.sqrt(c2) + eps)
                    p[k], m[k], v[k] = pf.to(store), mf.to(store), vf.to(store)
            del leaves, grads
        with torch.no_grad():
            norms = torch.stack([(p[k].float() - weights[k].float()).norm() for k in p]).tolist()
    return Readings(losses=losses, grad_norms=grad_norms, change_norms=dict(zip(p, norms)), first_grads=first_grads)
