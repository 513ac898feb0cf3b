"""Ring attention: exact causal attention over a sequence-sharded mesh dimension.

Counterpart of ``torchsnapshot_tpu/ops/ring_attention.py``. Each rank of
the ``sp`` dimension of a ``DeviceMesh`` holds one block of the sequence,
``(batch, s_local, heads, dim)``, and keeps its query block while the
key/value blocks rotate around the ring: at step ``t`` rank ``r`` holds
the block of rank ``(r - t) mod n`` and merges that block's contribution
into an online-softmax carry ``(acc, m, l)``. The full ``(seq, seq)``
score matrix exists nowhere.

- ``use_flash=False`` (``attn_impl="ring"``): each step's block is plain
  f32 einsums, differentiable through autograd; a hop's backward sends
  the cotangent back to the block's owner.
- ``use_flash=True`` (``attn_impl="ring_flash"``): each step's block runs
  in the chunk kernel (:func:`~.flash_attention.flash_attention_chunk`):
  unmasked for a block behind the resident queries, causal on the
  diagonal, nothing for a block ahead. The kernel has no backward; as
  the JAX ``custom_vjp`` does, the backward recomputes through the
  einsum ring, which computes the same function.

A hop moves K and V as one stacked buffer with the pipeline's transport
(:class:`~..parallel.pipeline._Ring`): a ``batch_isend_irecv`` pair on the
``sp`` group, through the host for a CUDA tensor on gloo (the route of
two ranks on one card). Its moves count in the telemetry registry under
``kind="ring"``. Every rank runs the same sends and receives in the same
order, forward and backward, so gloo pairs the right buffers. The JAX
ring also rotates after its last step; that hop changes no number and is
left out here.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from ..parallel.pipeline import _mesh_dim, _Ring
from .attention import causal_attention
from .flash_attention import _KERNEL_TILE, flash_attention_chunk

# The masked logit and the initial row max: finite, so that a fully masked
# block keeps the running max finite and exp() exactly zero.
_NEG_INF = -1e30


class _RingHop(torch.autograd.Function):
    """K/V ``r -> r + 1`` forward; the cotangent ``r + 1 -> r`` backward."""

    @staticmethod
    def forward(ctx: Any, kv: torch.Tensor, ring: _Ring) -> torch.Tensor:
        ctx.ring = ring
        return ring.shift(kv, 1, kind="ring")

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return ctx.ring.shift(g, -1, kind="ring"), None


def _contrib_einsum(qf, k_t, v_t, q_pos, k_pos):
    """One block's ``(acc, m, l)`` from f32 einsums, the mask by global
    positions; shapes ``(b, h, s, d)`` and ``(b, h, s)``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k_t.float())
    mask = q_pos[:, None] >= k_pos[None, :]
    logits = torch.where(mask, logits, _NEG_INF)
    m_c = logits.amax(dim=-1)
    # A fully masked block gives p = exp(_NEG_INF - m) = 1: zeroed here.
    p = torch.where(mask, torch.exp(logits - m_c[..., None]), 0.0)
    l_c = p.sum(dim=-1)
    o_c = torch.einsum("bhqk,bkhd->bhqd", p, v_t.float())
    return o_c, m_c, l_c


def _ring_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring: _Ring, use_flash: bool) -> torch.Tensor:
    """This rank's output block ``(b, s, h, d)`` in q's dtype; the JAX
    ``_ring_attention_local``."""
    r, n = ring.r, ring.n
    b, s, h, d = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=q.device))
    qf = q.float() * scale
    local_pos = torch.arange(s, device=q.device)
    q_pos = r * s + local_pos
    o = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    kv = torch.stack((k, v))
    for t in range(n):
        if t:
            kv = _RingHop.apply(kv, ring)
        src = (r - t) % n
        if not use_flash:
            o_c, m_c, l_c = _contrib_einsum(qf, kv[0], kv[1], q_pos, src * s + local_pos)
        elif src <= r:
            o_c, m_c, l_c = flash_attention_chunk(q, kv[0], kv[1], causal=src == r)
        else:
            # A block ahead of every resident query contributes nothing.
            o_c, m_c, l_c = torch.zeros_like(o), torch.full_like(m, _NEG_INF), torch.zeros_like(l)
        # The two-way online-softmax merge of the block into the carry.
        m_new = torch.maximum(m, m_c)
        corr = torch.exp(m - m_new)
        corr_c = torch.exp(m_c - m_new)
        l = l * corr + l_c * corr_c
        o = o * corr[..., None] + o_c * corr_c[..., None]
        m = m_new
    out = o / l[..., None]  # every query sees at least its own position: l > 0
    return out.permute(0, 2, 1, 3).to(q.dtype)


class _RingFlash(torch.autograd.Function):
    """Forward: the ring with the chunk kernel. Backward: the vjp of the
    einsum ring, recomputed from the saved q, k, v."""

    @staticmethod
    def forward(ctx: Any, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring: _Ring) -> torch.Tensor:
        ctx.ring = ring
        ctx.save_for_backward(q, k, v)
        return _ring_local(q, k, v, ring, use_flash=True)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _ring_local(*inputs, ctx.ring, use_flash=False)
            dq, dk, dv = torch.autograd.grad(out, inputs, g)
        return dq, dk, dv, None


def sp_size(mesh: Optional[Any], axis_name: str = "sp") -> int:
    """The size of ``mesh``'s ``axis_name`` dimension (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(_mesh_dim(mesh, axis_name))


def ring_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Optional[Any] = None,
    axis_name: str = "sp",
    use_flash: bool = False,
) -> torch.Tensor:
    """Exact causal attention with the sequence sharded over ``axis_name``.

    Args:
        q, k, v: this rank's blocks ``(batch, s_local, heads, dim)``; rank
            ``r`` of the ``axis_name`` dimension holds global positions
            ``[r * s_local, (r + 1) * s_local)``.
        mesh: a ``DeviceMesh`` with an ``axis_name`` dimension. ``None``,
            or a dimension of size 1, runs the dense op.
        use_flash: each ring step in the chunk kernel (the kernel on a CUDA
            tensor, its plain version on a CPU one); needs
            ``s_local % 64 == 0``, and raises otherwise.

    Returns:
        This rank's output block ``(batch, s_local, heads, dim)``, equal
        (up to f32 roundoff) to its block of the dense causal attention
        over the whole sequence. Differentiable in q, k and v.
    """
    if sp_size(mesh, axis_name) == 1:
        return causal_attention(q, k, v)
    if use_flash and q.shape[1] % _KERNEL_TILE:
        raise ValueError(
            f"ring_flash needs the local sequence length to divide by {_KERNEL_TILE}, got "
            f"s_local={q.shape[1]}; pad the sequence or use attn_impl='ring'"
        )
    ring = _Ring(mesh, axis_name)
    if use_flash:
        return _RingFlash.apply(q, k, v, ring)
    return _ring_local(q, k, v, ring, use_flash=False)


def ring_attention_block_specs(mesh: Any, axis_name: str = "sp") -> Tuple[List[Any], List[Any]]:
    """``(activation, qkv)`` placements that give the ring its blocks
    without resharding: the sequence (dim 1) ``Shard(1)`` over
    ``axis_name``, the batch ``Shard(0)`` over a ``dp`` dimension, and
    ``Replicate()`` over any other."""
    from torch.distributed.tensor import Replicate, Shard

    sp = _mesh_dim(mesh, axis_name)
    names = mesh.mesh_dim_names
    placements = [
        Shard(1) if i == sp else Shard(0) if names[i] == "dp" else Replicate() for i in range(mesh.ndim)
    ]
    return list(placements), list(placements)


__all__ = ["ring_attention_block_specs", "ring_causal_attention", "sp_size"]
