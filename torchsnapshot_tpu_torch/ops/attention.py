"""Causal multi-head attention, the plain dense version.

Counterpart of ``torchsnapshot_tpu/ops/attention.py``: the full
``(b, h, s, s)`` logits in f32, softmax in f32, probabilities cast back to
the input dtype before the product with v.
"""

from __future__ import annotations

import torch


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal scaled-dot-product attention.

    Args:
        q, k, v: ``(batch, seq, n_heads, head_dim)``.

    Returns:
        ``(batch, seq, n_heads, head_dim)``.
    """
    scale = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale.to(q.device)
    s = logits.shape[-1]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(causal, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
