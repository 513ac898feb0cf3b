"""Fused blockwise causal attention (flash attention forward) for the card.

Counterpart of ``torchsnapshot_tpu/ops/flash_attention.py``. Its two Pallas
kernels become one hand-written CUDA kernel for Hopper
(``csrc/flash_attention.cu``) with two entry points:

- :func:`flash_causal_forward` replaces ``_flash_kernel`` (through
  ``_flash_causal_forward``): causal attention, normalized, in the input
  dtype. It is the primal, e.g. an evaluation forward.
- :func:`flash_attention_chunk` replaces ``_flash_chunk_kernel`` (through
  ``flash_attention_chunk``): causal or unmasked attention of q against one
  K/V chunk, returning the unnormalized f32 accumulator and the row max /
  normalizer. It is the forward of every training step.

Beside each kernel sits its plain PyTorch version: the blockwise online
softmax of the Pallas body, in f32. A wrapper runs the plain version only
for tensors on the CPU; for a CUDA tensor it launches the kernel or raises.

:func:`flash_causal_attention` is the differentiable entry point: under
autograd it runs the chunk kernel and the blockwise backward
(:func:`flash_bwd_blockwise`, a plain function as in the JAX package,
where it is pure lax outside any kernel); otherwise the fused kernel.

Layouts follow the JAX package: q, k, v are ``(batch, seq, heads, dim)``.
The kernel reads them through their strides (the head dim must be
contiguous), so the q/k/v slices of a fused qkv projection need no copy.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import kernels

_NEG_BIG = -1e30
# The CUDA kernel's q and k tile (csrc/flash_attention.cu kBlockQ/kBlockK).
_KERNEL_TILE = 64
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches per entry point. Incremented only where a kernel is
# launched; plain (CPU) runs do not count.
launch_counts: Dict[str, int] = {"flash_fwd": 0, "flash_chunk": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ----------------------------------------------------------------------
# Plain versions (the Pallas bodies, blockwise, in f32)
# ----------------------------------------------------------------------


def _blockwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    block_q: int,
    block_k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Online-softmax attention tile by tile, exactly as the Pallas grid
    walks it: ``(acc, m, l)`` with ``acc`` ``(b, h, s_q, d)`` and ``m``,
    ``l`` ``(b, h, s_q)``, all f32."""
    d = q.shape[-1]
    scale = 1.0 / (d**0.5)
    qh = q.transpose(1, 2).float() * scale
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2).float()
    sq, sk = qh.shape[2], kh.shape[2]
    accs, ms, ls = [], [], []
    for qi in range(sq // block_q):
        qb = qh[:, :, qi * block_q : (qi + 1) * block_q]
        shape = qb.shape[:3] + (1,)
        m = torch.full(shape, _NEG_BIG, dtype=torch.float32, device=q.device)
        l = torch.zeros(shape, dtype=torch.float32, device=q.device)
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        for ki in range(sk // block_k):
            if causal and ki * block_k > qi * block_q + block_q - 1:
                break  # past the causal frontier: contributes nothing
            kb = kh[:, :, ki * block_k : (ki + 1) * block_k]
            vb = vh[:, :, ki * block_k : (ki + 1) * block_k]
            logits = qb @ kb.transpose(-1, -2)
            if causal:
                q_pos = qi * block_q + torch.arange(block_q, device=q.device)
                k_pos = ki * block_k + torch.arange(block_k, device=q.device)
                logits = torch.where(
                    q_pos[:, None] >= k_pos[None, :], logits, _NEG_BIG
                )
            m_next = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            p = torch.exp(logits - m_next)
            alpha = torch.exp(m - m_next)
            m = m_next
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vb
        accs.append(acc)
        ms.append(m[..., 0])
        ls.append(l[..., 0])
    return torch.cat(accs, dim=2), torch.cat(ms, dim=2), torch.cat(ls, dim=2)


def flash_causal_forward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Plain version of the fused kernel: ``(b, s, h, d)`` in q's dtype."""
    acc, _, l = _blockwise(q, k, v, True, block_q, block_k)
    return (acc / l[..., None]).to(q.dtype).transpose(1, 2)


def flash_attention_chunk_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    block_q: int = 128,
    block_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the chunk kernel: ``(o, m, l)``, all f32."""
    return _blockwise(q, k, v, causal, block_q, block_k)


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------


def _check_blocks(sq: int, sk: int, block_q: int, block_k: int) -> Tuple[int, int]:
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(
            f"seq lengths ({sq}, {sk}) must divide by blocks ({block_q}, {block_k})"
        )
    return block_q, block_k


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the CUDA kernel takes; anything else raises."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(
                f"{name} must be (batch, seq, heads, dim) with a contiguous "
                f"head dim, got shape {tuple(t.shape)} strides {t.stride()}"
            )
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the CUDA flash kernel takes float32 or bfloat16, got {q.dtype}")
    b, sq, h, d = q.shape
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernel takes head dims {_KERNEL_HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.stride() != v.stride():
        raise ValueError("k and v must have the same shape and strides")
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if sq % _KERNEL_TILE or k.shape[1] % _KERNEL_TILE:
        raise ValueError(
            f"the CUDA flash kernel needs seq lengths divisible by {_KERNEL_TILE}, "
            f"got ({sq}, {k.shape[1]})"
        )


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def _library() -> ctypes.CDLL:
    lib = kernels.library("flash_attention")
    if not getattr(lib, "_ts_declared", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ts_flash_fwd.argtypes = [ptr] * 4 + [i32] * 5 + [i64] * 6 + [ptr]
        lib.ts_flash_fwd.restype = i32
        lib.ts_flash_chunk.argtypes = [ptr] * 6 + [i32] * 7 + [i64] * 6 + [ptr]
        lib.ts_flash_chunk.restype = i32
        lib._ts_declared = True
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def flash_causal_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Causal flash attention, normalized, in q's dtype, ``(b, s, h, d)``.
    The fused kernel on a CUDA tensor; the plain version on a CPU one."""
    b, s, h, d = q.shape
    if s % block_q or s % block_k:
        raise ValueError(
            f"seq {s} must be a multiple of block_q={block_q} and block_k={block_k}"
        )
    if q.device.type == "cpu":
        return flash_causal_forward_plain(q, k, v, block_q, block_k)
    _check_kernel_inputs(q, k, v)
    if k.shape[1] != s:
        raise ValueError("the causal forward needs k/v as long as q")
    lib = _library()
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.ts_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, h, s, d, *_strides(q), *_strides(k),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "flash_fwd")
    launch_counts["flash_fwd"] += 1
    return o


def flash_attention_chunk(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    block_q: int = 128,
    block_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Streamed blockwise attention of ``q`` against one K/V chunk.

    Args:
        q: ``(batch, s_q, heads, dim)``; k, v: ``(batch, s_k, heads, dim)``.
        causal: apply the chunk-local causal mask; ``False`` means every
            key of the chunk is visible.

    Returns:
        ``(o, m, l)``: the unnormalized f32 accumulator ``(b, h, s_q, d)``
        and the row max / normalizer ``(b, h, s_q)``, f32.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    block_q, block_k = _check_blocks(sq, sk, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_chunk_plain(q, k, v, causal, block_q, block_k)
    _check_kernel_inputs(q, k, v)
    lib = _library()
    o = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.ts_flash_chunk(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
            l.data_ptr(), _KERNEL_DTYPES[q.dtype], int(causal), b, h, sq, sk, d,
            *_strides(q), *_strides(k),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "flash_chunk")
    launch_counts["flash_chunk"] += 1
    return o, m, l


# ----------------------------------------------------------------------
# Backward and the differentiable entry point
# ----------------------------------------------------------------------


def flash_bwd_blockwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    block_k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal flash attention backward, blockwise over key tiles: each
    tile's probabilities are recomputed from the saved (max, normalizer),
    so temporaries are O(s * block_k). With P the softmax tile and
    D = rowsum(dO * O): dS = P * (dO V^T - D), dQ = scale dS K,
    dK = scale dS^T Q, dV = P^T dO.

    Shapes: q/k/v/o/do ``(b, h, s, d)`` f32, m/l ``(b, h, s)``.
    """
    s, d = q.shape[2], q.shape[3]
    scale = 1.0 / (d**0.5)
    pos = torch.arange(s, device=q.device)
    D = (do * o).sum(dim=-1, keepdim=True)
    m, l = m[..., None], l[..., None]
    dq = torch.zeros_like(q)
    dks, dvs = [], []
    for j in range(s // block_k):
        kj = k[:, :, j * block_k : (j + 1) * block_k]
        vj = v[:, :, j * block_k : (j + 1) * block_k]
        k_pos = j * block_k + torch.arange(block_k, device=q.device)
        sj = scale * (q @ kj.transpose(-1, -2))
        p = torch.where(
            pos[:, None] >= k_pos[None, :], torch.exp(sj - m) / l, 0.0
        )
        ds = p * (do @ vj.transpose(-1, -2) - D)
        dq = dq + scale * (ds @ kj)
        dks.append(scale * (ds.transpose(-1, -2) @ q))
        dvs.append(p.transpose(-1, -2) @ do)
    return dq, torch.cat(dks, dim=2), torch.cat(dvs, dim=2)


class _FlashCausal(torch.autograd.Function):
    """Forward: the chunk kernel (which also yields the stats the backward
    needs), normalized here. Backward: :func:`flash_bwd_blockwise`."""

    @staticmethod
    def forward(ctx, q, k, v, block_q: int, block_k: int):
        o_u, m, l = flash_attention_chunk(
            q, k, v, causal=True, block_q=block_q, block_k=block_k
        )
        o = o_u / l[..., None]  # (b, h, s, d) f32, normalized
        ctx.save_for_backward(q, k, v, m, l, o)
        ctx.block_k = min(block_k, q.shape[1])
        return o.transpose(1, 2).to(q.dtype, memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        q, k, v, m, l, o = ctx.saved_tensors
        to_h = lambda x: x.transpose(1, 2).float()  # noqa: E731
        dq, dk, dv = flash_bwd_blockwise(
            to_h(q), to_h(k), to_h(v), m, l, o, to_h(g), ctx.block_k
        )
        back = lambda x, like: x.transpose(1, 2).to(like.dtype)  # noqa: E731
        return back(dq, q), back(dk, k), back(dv, v), None, None


def flash_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Drop-in for :func:`~torchsnapshot_tpu_torch.ops.causal_attention`
    where ``seq`` divides by the block sizes. Differentiable: under autograd
    the chunk kernel runs forward and the blockwise backward follows;
    otherwise the fused kernel runs alone.

    Args:
        q, k, v: ``(batch, seq, heads, dim)``.
        block_q, block_k: tile sizes of the plain (CPU) version; the CUDA
            kernel tiles by 64 and needs ``seq % 64 == 0``.
    """
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _FlashCausal.apply(q, k, v, block_q, block_k)
    return flash_causal_forward(q, k, v, block_q, block_k)


def attention_flops(b: int, h: int, s_q: int, s_k: int, d: int, causal: bool) -> float:
    """Multiply-adds x 2 of QK^T and PV that the inputs need (the causal
    mask halves them)."""
    full = 4.0 * b * h * s_q * s_k * d
    return full / 2 if causal else full


__all__ = [
    "attention_flops",
    "flash_attention_chunk",
    "flash_attention_chunk_plain",
    "flash_bwd_blockwise",
    "flash_causal_attention",
    "flash_causal_forward",
    "flash_causal_forward_plain",
    "launch_counts",
    "reset_launch_counts",
]
