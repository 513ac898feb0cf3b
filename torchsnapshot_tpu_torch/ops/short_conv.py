"""The gated short convolution of an LFM2 conv layer, on the card.

An LFM2 conv layer splits its ``in_proj`` output ``P`` ``(b, s, 3d)`` into
``B``, ``C`` and ``x`` along the last dimension and computes ``y = C *
conv(B * x)``: a depthwise causal convolution of three taps along the
sequence, its weight ``w`` ``(3, d)`` (taps by channels), each position
seeing itself and the two before it (zero before the sequence's start)::

    y[t] = C[t] * (w[0] Bx[t-2] + w[1] Bx[t-1] + w[2] Bx[t])

:func:`gated_short_conv` is the differentiable entry point, and routes in
one place (:func:`_on_kernels`): a bf16 input on a card runs the
hand-written kernels of ``csrc/short_conv.cu``, ``ts_short_conv_fwd``
forward and ``ts_short_conv_bwd`` backward (``dP`` in bf16 and the tap
gradient summed in f32, reduced over tiles in a fixed order, so two runs
give the same bits); their entries raise on a layout the kernels do not
take (a strided ``P``, a width not a multiple of 8), and never fall back.
Every other input (CPU tensors, f32) takes the plain versions here, in
f32: :func:`short_conv_plain` and :func:`short_conv_bwd_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import kernels

# Kernel launches per entry point; plain runs do not count.
launch_counts: Dict[str, int] = {"short_conv_fwd": 0, "short_conv_bwd": 0}
_VEC = 8  # channels a kernel thread loads at once (16 bytes of bf16)


# ----------------------------------------------------------------------
# Plain versions (f32)
# ----------------------------------------------------------------------


def _split(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    d = p.shape[-1] // 3
    return p[..., :d], p[..., d:2 * d], p[..., 2 * d:]


def _later(t: torch.Tensor, k: int) -> torch.Tensor:
    """``t`` moved ``k`` positions later along the sequence (dim -2), zeros first."""
    return F.pad(t, (0, 0, k, 0))[..., : t.shape[-2], :]


def _earlier(t: torch.Tensor, k: int) -> torch.Tensor:
    """``t`` moved ``k`` positions earlier along the sequence, zeros last."""
    return F.pad(t, (0, 0, 0, k))[..., k:, :]


def _taps(bx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return w[0] * _later(bx, 2) + w[1] * _later(bx, 1) + w[2] * bx


def short_conv_plain(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y`` ``(..., s, d)`` in ``p``'s dtype, computed in f32."""
    b, c, x = (t.float() for t in _split(p))
    return (c * _taps(b * x, w.float())).to(p.dtype)


def short_conv_bwd_plain(
    p: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dP, dw)``: ``dP`` like ``p``, ``dw`` ``(3, d)`` f32, computed in f32.
    With g = dy C: dC = dy conv(Bx); dBx[u] = w[2] g[u] + w[1] g[u+1] +
    w[0] g[u+2]; dB = dBx x; dx = dBx B; dw[j] = sum g[t] Bx[t-2+j]."""
    b, c, x = (t.float() for t in _split(p))
    wf, dyf = w.float(), dy.float()
    bx = b * x
    g = dyf * c
    dbx = wf[2] * g + wf[1] * _earlier(g, 1) + wf[0] * _earlier(g, 2)
    dp = torch.cat([dbx * x, dyf * _taps(bx, wf), dbx * b], dim=-1).to(p.dtype)
    lead = tuple(range(g.dim() - 1))
    dw = torch.stack([(g * _later(bx, 2)).sum(lead), (g * _later(bx, 1)).sum(lead), (g * bx).sum(lead)])
    return dp, dw


# ----------------------------------------------------------------------
# Kernels
# ----------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = kernels.library("short_conv")
    if not getattr(lib, "_ts_declared", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ts_short_conv_fwd.argtypes = [ptr] * 3 + [i64] * 3 + [i32, ptr]
        lib.ts_short_conv_fwd.restype = i32
        lib.ts_short_conv_bwd.argtypes = [ptr] * 6 + [i64] * 3 + [i32, ptr]
        lib.ts_short_conv_bwd.restype = i32
        lib.ts_short_conv_bwd_tiles.argtypes = [i64, i64]
        lib.ts_short_conv_bwd_tiles.restype = i64
        lib._ts_declared = True
    return lib


def kernel_takes(p: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the kernels take these inputs: bf16 on a card, ``p`` a
    contiguous ``(b, s, 3d)`` and ``w`` a contiguous ``(3, d)``, d a
    multiple of 8, both 16-byte aligned."""
    if p.device.type != "cuda" or p.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        return False
    if p.dim() != 3 or p.shape[-1] % 3 or w.device != p.device:
        return False
    d = p.shape[-1] // 3
    return (
        d % _VEC == 0 and tuple(w.shape) == (3, d) and p.is_contiguous() and w.is_contiguous()
        and p.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    )


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def short_conv_fwd(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y`` ``(b, s, d)`` by the forward kernel; raises on inputs it does
    not take."""
    if not kernel_takes(p, w):
        raise ValueError(
            f"ts_short_conv_fwd takes contiguous bf16 (b, s, 3d) and (3, d), d % 8 == 0; got "
            f"{tuple(p.shape)} {p.dtype} and {tuple(w.shape)} {w.dtype}"
        )
    b, s, d3 = p.shape
    y = torch.empty((b, s, d3 // 3), dtype=p.dtype, device=p.device)
    err = _library().ts_short_conv_fwd(
        p.data_ptr(), w.data_ptr(), y.data_ptr(), b, s, d3 // 3, p.device.index,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    _raise_on(err, "short_conv_fwd")
    launch_counts["short_conv_fwd"] += 1
    return y


def short_conv_bwd(
    p: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dP, dw)``, ``dw`` f32, by the backward kernels; raises on inputs
    they do not take."""
    if not kernel_takes(p, w) or tuple(dy.shape) != (*p.shape[:2], p.shape[2] // 3) or dy.dtype != p.dtype:
        raise ValueError(
            f"ts_short_conv_bwd takes contiguous bf16 (b, s, 3d), (3, d) and (b, s, d), d % 8 == 0; "
            f"got {tuple(p.shape)} {p.dtype}, {tuple(w.shape)} {w.dtype}, {tuple(dy.shape)} {dy.dtype}"
        )
    b, s, d3 = p.shape
    d = d3 // 3
    lib = _library()
    dy = dy.contiguous()
    dp = torch.empty_like(p)
    partial = torch.empty((lib.ts_short_conv_bwd_tiles(b, s), 3, d), dtype=torch.float32, device=p.device)
    dw = torch.empty((3, d), dtype=torch.float32, device=p.device)
    err = lib.ts_short_conv_bwd(
        p.data_ptr(), w.data_ptr(), dy.data_ptr(), dp.data_ptr(), partial.data_ptr(), dw.data_ptr(),
        b, s, d, p.device.index, torch.cuda.current_stream(p.device).cuda_stream,
    )
    _raise_on(err, "short_conv_bwd")
    launch_counts["short_conv_bwd"] += 1
    return dp, dw


def _on_kernels(p: torch.Tensor) -> bool:
    """The route: bf16 on a card takes the kernels, anything else the plain
    versions."""
    return p.device.type == "cuda" and p.dtype == torch.bfloat16


class _ShortConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, w):
        ctx.save_for_backward(p, w)
        return short_conv_fwd(p, w) if _on_kernels(p) else short_conv_plain(p, w)

    @staticmethod
    def backward(ctx, dy):
        p, w = ctx.saved_tensors
        dp, dw = short_conv_bwd(p, w, dy) if _on_kernels(p) else short_conv_bwd_plain(p, w, dy)
        return dp, dw.to(w.dtype)


def gated_short_conv(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``C * conv(B * x)`` of ``P`` ``(..., s, 3d)`` = (B, C, x) with taps
    ``w`` ``(3, d)``; differentiable in both."""
    return _ShortConv.apply(p, w)

