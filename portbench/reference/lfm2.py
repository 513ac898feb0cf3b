"""LFM2-MoE's training step in plain PyTorch, float32, through
``reference.model.follow``. It imports nothing of the program.

The architecture (https://huggingface.co/LiquidAI/LFM2-8B-A1B), as
``configs/lfm2-8b-a1b.json`` states it, for one sequence ``row``:

- a token embedding; per block ``h = x + mixer(rmsnorm(x))``, then
  ``out = h + ffn(rmsnorm(h))`` (RMSNorm with a scale, eps ``norm_eps``);
- a short-conv mixer: ``B, C, x' = split3(h @ in_proj)``, ``y = C *
  conv(B * x')`` by ``F.conv1d`` (groups = d, the three taps ``conv[:, c]``
  of channel c, two zeros padded on the left, no bias), then ``@ out_proj``;
- an attention mixer: q, k, v projections, an RMSNorm of each head of q
  and k, rotate-half rotary embeddings (base ``rope_theta``, positions
  0..s-1), K and V repeated to every query head of their group, causal
  softmax attention by explicit scores, in blocks of ``QUERY_BLOCK``
  queries (each against the keys up to its last), then ``@ o``;
- a dense SwiGLU ``w2(silu(h w1) * h w3)`` in the leading dense layers;
- a sparse layer: ``s = sigmoid(h @ router)``, the ``top_k`` experts on
  ``s + expert_bias``, weights ``s`` at the chosen ones over their sum;
  each held expert's SwiGLU on the tokens that chose it, weighted;
- a final RMSNorm and the head tied to the embedding; the loss the summed
  next-token cross-entropy of the row (``follow`` divides by the batch's
  count).

Departures from the published description, the program's alike: the
held-expert share (the layer computes the part of the result that the
experts ``experts_first .. experts_first + experts_held - 1`` give; what
absent experts would add is left out, with no exchange); ``expert_bias``
is not updated (the published configuration gives no rule), so it is
read, never trained, and not among the readings; the head is tied to the
embedding (assumed, ``configs/lfm2-8b-a1b.json``); the depth is the
configuration's ``layer_types``.

``compute="fp8"`` is the control: the inputs of every matrix product
(the router's, the attention's, each expert's and the head's included)
rounded to float8 e4m3 with a per-tensor scale. ``dims`` is the adapter's
(``archs/lfm2.py``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

from reference.model import Readings, follow, round_fp8

QUERY_BLOCK = 1024  # query rows of one block of attention scores
FROZEN = "expert_bias"  # leaves read but not trained


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embeddings of ``x`` ``(s, heads, hd)``."""
    s, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    angles = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv[None]
    angles = torch.cat([angles, angles], dim=-1)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return x * angles.cos() + torch.cat([-x2, x1], dim=-1) * angles.sin()


def short_conv(h: torch.Tensor, in_proj: torch.Tensor, taps: torch.Tensor, mm: Callable) -> torch.Tensor:
    d = in_proj.shape[-1] // 3
    b, c, x = mm(h, in_proj).split(d, dim=-1)
    bx = (b * x).t()[None]  # (1, d, s)
    conv = F.conv1d(F.pad(bx, (2, 0)), taps.t()[:, None], groups=d)[0].t()
    return c * conv


def attention(h: torch.Tensor, p: Mapping[str, torch.Tensor], blk: str, dims: Any, mm: Callable) -> torch.Tensor:
    s = h.shape[0]
    nh, kv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = rmsnorm(mm(h, p[blk + "q"]).view(s, nh, hd), p[blk + "q_norm"], dims.norm_eps)
    k = rmsnorm(mm(h, p[blk + "k"]).view(s, kv, hd), p[blk + "k_norm"], dims.norm_eps)
    v = mm(h, p[blk + "v"]).view(s, kv, hd)
    q, k = rope(q, dims.rope_theta).transpose(0, 1), rope(k, dims.rope_theta)
    k = k.repeat_interleave(nh // kv, dim=1).transpose(0, 1)  # (nh, s, hd)
    v = v.repeat_interleave(nh // kv, dim=1).transpose(0, 1)
    pos = torch.arange(s, device=h.device)
    out = []
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, s)
        scores = mm(q[:, q0:q1], k[:, :q1].transpose(-1, -2)) / math.sqrt(hd)
        visible = pos[q0:q1, None] >= pos[None, :q1]
        probs = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
        out.append(mm(probs, v[:, :q1]))
    return mm(torch.cat(out, dim=1).transpose(0, 1).reshape(s, nh * hd), p[blk + "o"])


def route(h: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, top_k: int, mm: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(experts, weights)`` ``(s, top_k)``."""
    scores = torch.sigmoid(mm(h, router))
    experts = torch.topk(scores + bias, top_k, dim=-1).indices
    weights = scores.gather(1, experts)
    return experts, weights / weights.sum(dim=-1, keepdim=True)


def held_experts(h: torch.Tensor, p: Mapping[str, torch.Tensor], blk: str, dims: Any, mm: Callable) -> torch.Tensor:
    """The held experts' part of a sparse layer's output."""
    experts, weights = route(h, p[blk + "router"], p[blk + FROZEN], dims.top_k, mm)
    out = torch.zeros_like(h)
    for j in range(dims.experts_held):
        hit = experts == dims.experts_first + j
        tokens = hit.any(dim=1).nonzero().squeeze(1)
        if tokens.numel() == 0:
            continue
        he = h[tokens]
        ye = mm(F.silu(mm(he, p[blk + "w1"][j])) * mm(he, p[blk + "w3"][j]), p[blk + "w2"][j])
        out = out.index_add(0, tokens, ye * (weights * hit).sum(dim=1)[tokens, None])
    return out


def row_logits(p: Mapping[str, torch.Tensor], row: torch.Tensor, dims: Any, compute: str) -> torch.Tensor:
    """The logits ``(s, vocab)`` of one sequence ``row`` (s,); ``p`` holds
    every leaf, the frozen ones too."""
    q8 = round_fp8 if compute == "fp8" else (lambda t: t)

    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return q8(a) @ q8(b)

    eps = dims.norm_eps
    x = p["embed"][row]
    for i, kind in enumerate(dims.layer_types):
        blk = f"layers/{i}/"
        h = rmsnorm(x, p[blk + "operator_norm"], eps)
        if kind == "conv":
            x = x + mm(short_conv(h, p[blk + "in_proj"], p[blk + "conv"], mm), p[blk + "out_proj"])
        else:
            x = x + attention(h, p, blk, dims, mm)
        h = rmsnorm(x, p[blk + "ffn_norm"], eps)
        if blk + "router" in p:
            x = x + held_experts(h, p, blk, dims, mm)
        else:
            x = x + mm(F.silu(mm(h, p[blk + "w1"])) * mm(h, p[blk + "w3"]), p[blk + "w2"])
    return mm(rmsnorm(x, p["final_norm"], eps), p["embed"].t())


def row_loss(p: Mapping[str, torch.Tensor], row: torch.Tensor, dims: Any, compute: str) -> torch.Tensor:
    """Summed next-token cross-entropy of one sequence ``row`` (s,)."""
    return F.cross_entropy(row_logits(p, row, dims, compute)[:-1], row[1:], reduction="sum")


def train_readings(
    weights: Mapping[str, torch.Tensor], batches: Sequence[torch.Tensor], dims: Any, lr: float,
    betas: Sequence[float], eps: float, weight_decay: float, compute: str = "f32",
    keep_first_grads: bool = False,
) -> Readings:
    """``follow`` with this ``row_loss``; the frozen leaves (``expert_bias``)
    are read in float32 and left out of the readings."""
    frozen = {k: w.float() for k, w in weights.items() if k.endswith(FROZEN)}
    trained = {k: w for k, w in weights.items() if k not in frozen}

    def loss_of_row(p: Mapping[str, torch.Tensor], row: torch.Tensor, d: Any, c: str) -> torch.Tensor:
        return row_loss({**p, **frozen}, row, d, c)

    return follow(loss_of_row, trained, batches, dims, lr, betas, eps, weight_decay, compute, keep_first_grads)
