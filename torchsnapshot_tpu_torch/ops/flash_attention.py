"""Fused blockwise causal attention (flash attention forward) for the card.

Counterpart of ``torchsnapshot_tpu/ops/flash_attention.py``. Its two Pallas
kernels become hand-written CUDA kernels for Hopper
(``csrc/flash_attention.cu``: TMA loads and ``wgmma`` tensor cores, for
bf16 directly and for f32 through a 3xTF32 split) with two entry points:

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
autograd it runs the chunk kernel forward; otherwise the fused kernel. Its
backward is the kernel pair behind :func:`flash_bwd` (bf16 at d = 64 on the
card: a dK/dV kernel over key tiles and a dQ kernel over q tiles, on the
same TMA + wgmma pipeline), which replaces no Pallas kernel: the JAX
package's backward is pure lax. Every other input takes its plain version,
:func:`flash_bwd_blockwise`.

Layouts follow the JAX package: q, k, v are ``(batch, seq, heads, dim)``.
The kernels read them through their strides (the head dim must be
contiguous), so the q/k/v slices of a fused qkv projection need no copy.
The bf16 kernel reads through TMA tensor maps, which need 16-byte-aligned
bases and strides. For f32 a pre-pass kernel first reads q, k, v through
their strides and writes the 3xTF32 split scratch that the tensor-core
kernel reads (:func:`flash_split_plain` is its plain version).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import kernels

_NEG_BIG = -1e30
# Sequence lengths the CUDA kernels take: multiples of the pre-pass's 64-row
# tile, which the tensor-core kernel's 128-row q tiles reach by masking a
# half tile.
_KERNEL_TILE = 64
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# The kernel's dtype codes: bf16 q, k, v read in place; f32 as the pre-pass's
# split scratch.
_BF16, _F32_SPLIT = 1, 2
# TMA (the bf16 kernel's loads) reads from 16-byte-aligned bases and strides.
_TMA_ALIGN = 16

# Head dims the backward kernel takes (bf16 only; its sequence lengths are
# the forward's, multiples of _KERNEL_TILE).
_BWD_HEAD_DIMS = (64,)

# Kernel launches per entry point. Incremented only where a kernel is
# launched; plain (CPU) runs do not count. ``flash_bwd`` counts calls of the
# backward's C entry (its pre-pass and two kernels).
launch_counts: Dict[str, int] = {"flash_fwd": 0, "flash_chunk": 0, "flash_split": 0, "flash_bwd": 0}
# The chunk kernel's launches by mask mode (they sum to its count above).
chunk_launches_by_mode: Dict[str, int] = {"causal": 0, "unmasked": 0}
# The path each backward of flash_causal_attention took: the kernel or the
# plain flash_bwd_blockwise.
backward_paths: Dict[str, int] = {"kernel": 0, "plain": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, chunk_launches_by_mode, backward_paths):
        for name in counts:
            counts[name] = 0


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
# The 3xTF32 split (f32 inputs)
# ----------------------------------------------------------------------

# The bits a tf32 operand keeps: sign, exponent and the top 10 mantissa bits
# (0xFFFFE000 as an int32); the tensor cores read only these bits of an f32.
# Adding half of the dropped range first rounds the magnitude to nearest,
# ties away from zero (as cvt.rna.tf32.f32).
_TF32_KEEP = -(1 << 13)
_TF32_HALF = 1 << 12
# Within each group of 8 keys, position c of the split vᵀ holds key
# KEY_PERM[c]. The accumulator fragment of S gives a thread keys 2t, 2t+1 of
# each group; the tf32 A fragment of P V wants columns t, t+4. Storing key
# 2t at column t and key 2t+1 at column t+4 lets P go into the product as
# it lies in the registers.
KEY_PERM = (0, 2, 4, 6, 1, 3, 5, 7)
_KEY_UNPERM = tuple(KEY_PERM.index(c) for c in range(8))


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of a finite f32 tensor: ``hi`` is ``x`` rounded to tf32
    (to nearest, ties away from zero; its low 13 mantissa bits zero), ``lo =
    x - hi``, exact, so ``hi + lo == x`` and ``|lo| <= 2^-11 |x|``."""
    hi = ((x.contiguous().view(torch.int32) + _TF32_HALF) & _TF32_KEEP).view(torch.float32)
    return hi, x - hi


def permute_keys(x: torch.Tensor) -> torch.Tensor:
    """Reorder the last dim (keys, a multiple of 8) by :data:`KEY_PERM`
    within each group of 8."""
    return x.unflatten(-1, (-1, 8))[..., KEY_PERM].flatten(-2)


def unpermute_keys(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`permute_keys`."""
    return x.unflatten(-1, (-1, 8))[..., _KEY_UNPERM].flatten(-2)


def flash_split_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the pre-pass kernel: the scratch the f32 kernel
    reads. q ``(2, b, h, s_q, d)`` and k ``(2, b, h, s_k, d)`` as
    (hi, lo); vᵀ ``(2, b, h, d, s_k)`` as (hi, lo), keys permuted by
    :func:`permute_keys`. All contiguous f32."""
    qh, kh = (torch.stack(tf32_split(t.transpose(1, 2).float())) for t in (q, k))
    vt = permute_keys(v.transpose(1, 2).float().transpose(-1, -2))
    return qh, kh, torch.stack(tf32_split(vt))


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
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_tma(name, t)


def _check_tma(name: str, t: torch.Tensor) -> None:
    """A bf16 ``(b, s, h, d)`` tensor that a kernel loads with TMA. Checked
    on every launch, so shapes and strides are read once per tensor; strides
    are in 2-byte elements. The stride of a dimension of size 1 is never
    used, so it may be anything."""
    if t.data_ptr() % _TMA_ALIGN or any(
        n > 1 and st * 2 % _TMA_ALIGN for n, st in zip(t.shape[:3], t.stride()[:3])
    ):
        raise ValueError(
            f"the bf16 flash kernel loads {name} with TMA, which needs a "
            f"{_TMA_ALIGN}-byte-aligned base and strides; got address "
            f"{t.data_ptr():#x}, strides {t.stride()} (elements of "
            f"{t.element_size()} bytes)"
        )


def _check_bwd_inputs(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
) -> None:
    """What the backward kernel takes; anything else raises. q, k, v as the
    forward kernels take them, bf16 at a head dim of ``_BWD_HEAD_DIMS``, k
    and v as long as q; ``do`` like q (also loaded with TMA); ``o`` ``(b, h,
    s, d)`` and ``m``, ``l`` ``(b, h, s)``, contiguous f32."""
    _check_kernel_inputs(q, k, v)
    b, s, h, d = q.shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the backward kernel takes bfloat16, got {q.dtype}")
    if d not in _BWD_HEAD_DIMS:
        raise ValueError(f"the backward kernel takes head dims {_BWD_HEAD_DIMS}, got {d}")
    if k.shape[1] != s:
        raise ValueError("the causal backward needs k/v as long as q")
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(
            f"do must match q: got {tuple(do.shape)} {do.dtype} on {do.device}, "
            f"q {tuple(q.shape)} {q.dtype} on {q.device}"
        )
    if do.stride(-1) != 1:
        raise ValueError(f"do must have a contiguous head dim, got strides {do.stride()}")
    _check_tma("do", do)
    for name, t, shape in (("o", o, (b, h, s, d)), ("m", m, (b, h, s)), ("l", l, (b, h, s))):
        if (
            tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != q.device
            or not t.is_contiguous()
        ):
            raise ValueError(
                f"{name} must be contiguous float32 {shape} on {q.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}, strides {t.stride()}"
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
        lib.ts_flash_split_f32.argtypes = [ptr] * 6 + [i32] * 5 + [i64] * 6 + [ptr]
        lib.ts_flash_split_f32.restype = i32
        lib.ts_flash_bwd.argtypes = [ptr] * 11 + [i32] * 5 + [i64] * 9 + [ptr]
        lib.ts_flash_bwd.restype = i32
        lib._ts_declared = True
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _kernel_operands(
    lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dtype code, q, k, v)`` as the main kernel reads them: bf16 inputs
    themselves, or for f32 the split scratch that the pre-pass kernel writes
    (see :func:`flash_split_plain`). Call under the inputs' device."""
    b, sq, h, d = q.shape
    if q.dtype == torch.bfloat16:
        return _BF16, q, k, v
    sk = k.shape[1]
    qs = torch.empty((2, b, h, sq, d), dtype=torch.float32, device=q.device)
    ks = torch.empty((2, b, h, sk, d), dtype=torch.float32, device=q.device)
    vts = torch.empty((2, b, h, d, sk), dtype=torch.float32, device=q.device)
    err = lib.ts_flash_split_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        vts.data_ptr(), b, h, sq, sk, d, *_strides(q), *_strides(k),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_split")
    launch_counts["flash_split"] += 1
    return _F32_SPLIT, qs, ks, vts


def flash_split(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pre-pass kernel alone (f32 inputs): the split scratch, as
    :func:`flash_split_plain` lays it out. The kernel on a CUDA tensor; the
    plain version on a CPU one."""
    if q.device.type == "cpu":
        return flash_split_plain(q, k, v)
    _check_kernel_inputs(q, k, v)
    if q.dtype != torch.float32:
        raise ValueError(f"the split pre-pass takes float32, got {q.dtype}")
    with torch.cuda.device(q.device):
        return _kernel_operands(_library(), q, k, v)[1:]


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
        code, q_, k_, v_ = _kernel_operands(lib, q, k, v)
        err = lib.ts_flash_fwd(
            q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), o.data_ptr(),
            code, b, h, s, d, *_strides(q), *_strides(k),
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
        code, q_, k_, v_ = _kernel_operands(lib, q, k, v)
        err = lib.ts_flash_chunk(
            q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), o.data_ptr(), m.data_ptr(),
            l.data_ptr(), code, int(causal), b, h, sq, sk, d,
            *_strides(q), *_strides(k),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "flash_chunk")
    launch_counts["flash_chunk"] += 1
    chunk_launches_by_mode["causal" if causal else "unmasked"] += 1
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


def flash_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: :func:`flash_bwd_blockwise` on
    the inputs upcast to f32, ``(dq, dk, dv)`` ``(b, s, h, d)`` in
    ``out_dtype`` (default: each input's dtype). q, k, v, do ``(b, s, h,
    d)``; m, l ``(b, h, s)`` and o ``(b, h, s, d)`` f32, as the chunk
    entry's forward leaves them (o normalized). ``block_k`` must divide s
    (default: the largest power of two up to 128 that does)."""
    to_h = lambda x: x.transpose(1, 2).float()  # noqa: E731
    block_k = math.gcd(q.shape[1], 128) if block_k is None else block_k
    grads = flash_bwd_blockwise(to_h(q), to_h(k), to_h(v), m, l, o, to_h(do), block_k)
    return tuple(
        g.transpose(1, 2).to(like.dtype if out_dtype is None else out_dtype)
        for g, like in zip(grads, (q, k, v))
    )


def flash_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal flash attention backward: ``(dq, dk, dv)``, contiguous ``(b,
    s, h, d)``. The kernel on a CUDA tensor (bf16, d = 64; its f32 sums are
    rounded once, to ``out_dtype``: q's dtype, or f32 to see the sums); the
    plain version on a CPU one. Arguments as :func:`flash_bwd_plain`'s."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, m, l, o, do, out_dtype)
    _check_bwd_inputs(q, k, v, m, l, o, do)
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the backward kernel writes bfloat16 or float32, not {out_dtype}")
    b, s, h, d = q.shape
    lib = _library()
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=out_dtype, device=q.device) for _ in "qkv")
    stats = torch.empty((b, h, s, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.ts_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), int(out_dtype == torch.float32), b, h, s, d,
            *_strides(q), *_strides(k), *_strides(do),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "flash_bwd")
    launch_counts["flash_bwd"] += 1
    return dq, dk, dv


def _bwd_kernel_takes(device_type: str, dtype: torch.dtype, s: int, d: int) -> bool:
    """Whether the backward kernel takes inputs of this device type, dtype,
    sequence length and head dim, which is all the backward observes.
    Everything else (f32, CPU tensors, other head dims) runs
    :func:`flash_bwd_blockwise`."""
    return (
        device_type == "cuda" and dtype == torch.bfloat16 and d in _BWD_HEAD_DIMS
        and s % _KERNEL_TILE == 0
    )


class _FlashCausal(torch.autograd.Function):
    """Forward: the chunk kernel (which also yields the stats the backward
    needs), normalized here. Backward: the kernel behind :func:`flash_bwd`
    where it takes the inputs, else :func:`flash_bwd_blockwise`."""

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
        if _bwd_kernel_takes(q.device.type, q.dtype, q.shape[1], q.shape[3]):
            backward_paths["kernel"] += 1
            dq, dk, dv = flash_bwd(q, k, v, m, l, o, g.contiguous())
        else:
            backward_paths["plain"] += 1
            dq, dk, dv = flash_bwd_plain(q, k, v, m, l, o, g, block_k=ctx.block_k)
        return dq, dk, dv, None, None


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
            kernels choose their own tiles and need ``seq % 64 == 0``.
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


# ----------------------------------------------------------------------
# Kernel against plain version: the tolerances and the comparison
# ----------------------------------------------------------------------

# f32: kernel and plain version run the same f32 algorithm, summed in another
# order (other tiles, FMA contraction, tensor-core sums of exact bf16
# products, 3xTF32 products that drop ~2^-21 of each f32 one), so they differ
# by a few f32 ulps of the row sums. The f32
# kernel's outputs, and the chunk entry's m and l for either input dtype (f32
# logits, f32 probabilities), are held to this.
F32_TOL = 2e-5
# The fused entry's output (rtol, atol). bf16: both sides compute in f32 from
# the same bf16 inputs, agreeing to F32_TOL, and round to bf16 once; each
# rounding moves a value by at most half a bf16 ulp, so the two differ by at
# most one ulp, 2^-7 of the value (8 bits of significand). rtol 8e-3 is just
# above that; atol is F32_TOL, for values near 0.
FUSED_TOL = {torch.float32: (F32_TOL, F32_TOL), torch.bfloat16: (8e-3, F32_TOL)}
# The chunk entry's o/l from bf16 inputs: the bf16 kernel feeds P to the
# tensor cores as two bf16 terms, P_hi = bf16(P) and P_lo = bf16(P - P_hi),
# which leave at most 2^-16 of each weight (two roundings of 2^-8 each);
# o/l = sum_j p_j v_j / l then moves by at most 2^-16 of the largest |v| on
# top of F32_TOL, and never by more than 1e-4.
SPLIT_RESIDUAL = 2.0**-16
SPLIT_TOL_CAP = 1e-4
# The backward kernel's f32 sums (out_dtype f32) against flash_bwd_blockwise
# on the same inputs upcast to f32, relative to each gradient's largest
# magnitude. The kernel feeds P (to dV) and dS (to dK, dQ) to the tensor
# cores as two bf16 terms, which leave at most SPLIT_RESIDUAL of each; the
# roundings vary in sign, so a sum over up to s rows or keys moves by a few
# SPLIT_RESIDUAL of its terms' scale, far below 1e-4 (6.6 SPLIT_RESIDUAL)
# of the largest gradient. The rest is f32 sums in another order and
# ex2.approx (2^-22), each some ulps. The bf16 outputs are those f32 sums
# rounded once (to nearest even): bit for bit the f32 outputs rounded.
GRAD_TOL = 1e-4


def chunk_atol(v: torch.Tensor) -> float:
    """atol of the chunk entry's o/l against its plain version."""
    if v.dtype != torch.bfloat16:
        return F32_TOL
    return min(SPLIT_RESIDUAL * v.abs().max().item() + F32_TOL, SPLIT_TOL_CAP)


def compare_with_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block: int
) -> Dict[str, float]:
    """Run the fused entry (when ``s_q == s_k``) and the chunk entry (causal
    and unmasked) on ``q, k, v`` and their plain versions on the same inputs,
    and hold each output to its tolerance above; raises on a disagreement.
    Returns the largest |errors| (``flash_fwd``, ``flash_chunk_causal``,
    ``flash_chunk_unmasked``) and the chunk o/l atol used (``chunk_atol``)."""
    rec = {"chunk_atol": chunk_atol(v)}
    if q.shape[1] == k.shape[1]:
        rtol, atol = FUSED_TOL[q.dtype]
        out = flash_causal_forward(q, k, v, block, block).float()
        ref = flash_causal_forward_plain(q, k, v, block, block).float()
        rec["flash_fwd"] = (out - ref).abs().max().item()
        torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
    for causal in (True, False):
        o, m, l = flash_attention_chunk(q, k, v, causal, block, block)
        ro, rm, rl = flash_attention_chunk_plain(q, k, v, causal, block, block)
        # The accumulator and l grow with the number of visible keys, so the
        # output is compared normalized and l relative to its size.
        on, rn = o / l[..., None], ro / rl[..., None]
        rec["flash_chunk_causal" if causal else "flash_chunk_unmasked"] = max(
            (on - rn).abs().max().item(), (m - rm).abs().max().item()
        )
        torch.testing.assert_close(on, rn, rtol=F32_TOL, atol=rec["chunk_atol"])
        torch.testing.assert_close(m, rm, rtol=F32_TOL, atol=F32_TOL)
        torch.testing.assert_close(l, rl, rtol=F32_TOL, atol=0.0)
    return rec


def compare_bwd_with_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor
) -> Dict[str, float]:
    """Run the chunk entry's causal forward on ``q, k, v`` and, on its
    stats, the backward kernel (f32 and bf16 outputs) and its plain version
    (f32): the f32 gradients within GRAD_TOL of each plain gradient's
    largest magnitude, the bf16 ones the f32 ones rounded, bit for bit;
    raises on a disagreement. Returns the largest |errors| (``dq``, ``dk``,
    ``dv``)."""
    block = math.gcd(q.shape[1], 128)
    o_u, m, l = flash_attention_chunk(q, k, v, True, block, block)
    o = o_u / l[..., None]
    want = flash_bwd_plain(q, k, v, m, l, o, do, torch.float32)
    got = flash_bwd(q, k, v, m, l, o, do, torch.float32)
    got_low = flash_bwd(q, k, v, m, l, o, do)
    rec = {}
    for name, g, w, g_low in zip(("dq", "dk", "dv"), got, want, got_low):
        rec[name] = (g - w).abs().max().item()
        torch.testing.assert_close(g, w, rtol=0.0, atol=GRAD_TOL * w.abs().max().item())
        if not torch.equal(g_low, g.to(g_low.dtype)):
            raise AssertionError(f"{name}: the {g_low.dtype} output is not the f32 output rounded")
    return rec


__all__ = [
    "attention_flops",
    "backward_paths",
    "chunk_atol",
    "chunk_launches_by_mode",
    "compare_bwd_with_plain",
    "compare_with_plain",
    "flash_attention_chunk",
    "flash_attention_chunk_plain",
    "flash_bwd",
    "flash_bwd_blockwise",
    "flash_bwd_plain",
    "flash_causal_attention",
    "flash_causal_forward",
    "flash_causal_forward_plain",
    "flash_split",
    "flash_split_plain",
    "launch_counts",
    "permute_keys",
    "reset_launch_counts",
    "tf32_split",
    "unpermute_keys",
]
