"""The training step of the port's transformer with soft-routed MoE blocks
in plain PyTorch, float32, through ``reference.model.follow``.

As ``reference/model.py``'s dense blocks, and in a block that holds a
``router``: gates = softmax(y @ router) over the experts; each expert e
computes gelu_tanh(y @ w_in[e]) @ w_out[e] on every token; the block adds
the gate-weighted sum of the experts' outputs. ``compute="fp8"`` rounds
the inputs of every product, the einsums' too. A test copies this file to
``reference/soft_moe.py`` of a tiny benchmark."""

from __future__ import annotations

import math
from typing import Any, Mapping, Sequence

import torch
import torch.nn.functional as F

from reference.model import Readings, follow, rmsnorm, round_fp8


def row_loss(p: Mapping[str, torch.Tensor], row: torch.Tensor, dims: Any, compute: str) -> torch.Tensor:
    q8 = round_fp8 if compute == "fp8" else (lambda t: t)

    def mm(a, b):
        return q8(a) @ q8(b)

    def ein(eq, a, b):
        return torch.einsum(eq, q8(a), q8(b))

    s, d, h = row.shape[0], dims.d_model, dims.n_heads
    hd = d // h
    causal = torch.ones(s, s, dtype=torch.bool, device=row.device).tril()
    x = p["embed"][row]
    for i in range(dims.n_layers):
        blk = f"layers/{i}/"
        y = rmsnorm(x, p[blk + "ln1_scale"])
        qkv = mm(y, p[blk + "wqkv"]).view(s, 3, h, hd).permute(1, 2, 0, 3)
        q, k, v = qkv[0], qkv[1], qkv[2]
        probs = torch.softmax((mm(q, k.transpose(-1, -2)) / math.sqrt(hd)).masked_fill(~causal, float("-inf")), dim=-1)
        x = x + mm(mm(probs, v).transpose(0, 1).reshape(s, d), p[blk + "wo"])
        y = rmsnorm(x, p[blk + "ln2_scale"])
        if blk + "router" in p:
            router = p[blk + "router"]
            gates = torch.softmax(mm(y, router), dim=-1)  # (s, e)
            hidden = F.gelu(ein("sd,edf->esf", y, p[blk + "w_in"]), approximate="tanh")
            x = x + ein("esd,se->sd", ein("esf,efd->esd", hidden, p[blk + "w_out"]), gates)
        else:
            x = x + mm(F.gelu(mm(y, p[blk + "w_in"]), approximate="tanh"), p[blk + "w_out"])
    logits = mm(rmsnorm(x, p["ln_f_scale"]), p["unembed"])
    return F.cross_entropy(logits[:-1], row[1:], reduction="sum")


def train_readings(
    weights: Mapping[str, torch.Tensor], batches: Sequence[torch.Tensor], dims: Any, lr: float,
    betas: Sequence[float], eps: float, weight_decay: float, compute: str = "f32",
    keep_first_grads: bool = False,
) -> Readings:
    return follow(row_loss, weights, batches, dims, lr, betas, eps, weight_decay, compute, keep_first_grads)
