"""The training loss: the mean (or summed) integer-label cross-entropy of
logits ``(rows, V)`` against targets ``(rows,)``, computed in f32::

    loss[r] = logsumexp(x[r]) - x[r, t[r]]

:func:`cross_entropy` is the differentiable entry point, and routes in one
place (:func:`_on_kernels`): bf16 logits on a card run the hand-written
kernels of ``csrc/cross_entropy.cu``, ``ts_cross_entropy_fwd`` forward (each
row's log-sum-exp and loss in one pass over the bf16 logits; the rows'
losses are then summed by torch, in a fixed order, so two runs give the
same bits) and
``ts_cross_entropy_bwd`` backward (the bf16 gradient ``(softmax - onehot) g
/ divisor`` rounded once, the incoming gradient read on the card); their
entries raise on a layout they do not take (a strided row, V not a multiple
of 8) and never fall back, and a target outside ``[0, V)`` trips a
device-side assert. Every other input (CPU tensors, f32 logits) takes the
plain version here, :func:`cross_entropy_plain` (f32 log-sum-exp and
gather), under autograd.

Each call adds its rows to the registry's ``loss_rows_total`` under its
route (``kernel`` or ``plain``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import telemetry
from ..telemetry import names
from . import kernels

# Kernel launches per entry point; plain runs do not count.
launch_counts: Dict[str, int] = {"cross_entropy_fwd": 0, "cross_entropy_bwd": 0}
REDUCTIONS = ("mean", "sum")
_VEC = 8  # logits a kernel thread loads at once (16 bytes of bf16)


def cross_entropy_plain(logits: torch.Tensor, targets: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """The loss in f32 (f64 logits in f64) from logits of any float dtype;
    differentiable."""
    x = logits.to(torch.promote_types(logits.dtype, torch.float32))
    rows = x.logsumexp(dim=-1) - x.gather(-1, targets[:, None]).squeeze(-1)
    return rows.mean() if reduction == "mean" else rows.sum()


# ----------------------------------------------------------------------
# Kernels
# ----------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = kernels.library("cross_entropy")
    if not getattr(lib, "_ts_declared", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ts_cross_entropy_fwd.argtypes = [ptr] * 4 + [i64] * 2 + [i32, ptr]
        lib.ts_cross_entropy_fwd.restype = i32
        lib.ts_cross_entropy_bwd.argtypes = [ptr] * 5 + [i64] * 3 + [i32, ptr]
        lib.ts_cross_entropy_bwd.restype = i32
        lib._ts_declared = True
    return lib


def kernel_takes(logits: torch.Tensor, targets: torch.Tensor) -> bool:
    """Whether the kernels take these inputs: bf16 logits on a card, a
    contiguous ``(rows, V)`` with rows > 0, V a multiple of 8 and a 16-byte
    aligned base; int64 targets ``(rows,)`` on the same card."""
    if logits.device.type != "cuda" or logits.dtype != torch.bfloat16 or logits.dim() != 2:
        return False
    rows, vocab = logits.shape
    return (
        rows > 0 and vocab > 0 and vocab % _VEC == 0 and logits.is_contiguous() and logits.data_ptr() % 16 == 0
        and targets.dtype == torch.int64 and tuple(targets.shape) == (rows,) and targets.device == logits.device
    )


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _divisor(rows: int, reduction: str) -> int:
    return rows if reduction == "mean" else 1


def _check(logits: torch.Tensor, targets: torch.Tensor, what: str) -> None:
    if not kernel_takes(logits, targets):
        raise ValueError(
            f"{what} takes contiguous bf16 (rows, V) logits, V % 8 == 0, and int64 (rows,) targets on the same "
            f"card; got {tuple(logits.shape)} {logits.dtype} stride {logits.stride()} and "
            f"{tuple(targets.shape)} {targets.dtype}"
        )


def cross_entropy_fwd(
    logits: torch.Tensor, targets: torch.Tensor, reduction: str = "mean"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, lse)`` by the forward kernel: the reduced f32 loss (0-d),
    the sum of the rows' losses (over the rows for ``mean``), and each row's
    f32 log-sum-exp; raises on inputs it does not take."""
    _check(logits, targets, "ts_cross_entropy_fwd")
    rows, vocab = logits.shape
    targets = targets.contiguous()
    lse = torch.empty(rows, dtype=torch.float32, device=logits.device)
    row_loss = torch.empty(rows, dtype=torch.float32, device=logits.device)
    err = _library().ts_cross_entropy_fwd(
        logits.data_ptr(), targets.data_ptr(), lse.data_ptr(), row_loss.data_ptr(), rows, vocab,
        logits.device.index, torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _raise_on(err, "cross_entropy_fwd")
    launch_counts["cross_entropy_fwd"] += 1
    return row_loss.sum() / _divisor(rows, reduction), lse


def cross_entropy_bwd(
    logits: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor, grad: torch.Tensor, reduction: str = "mean"
) -> torch.Tensor:
    """The bf16 gradient of the reduced loss with respect to ``logits``,
    given its incoming gradient ``grad`` (a 0-d tensor on the card), by the
    backward kernel; raises on inputs it does not take."""
    _check(logits, targets, "ts_cross_entropy_bwd")
    rows, vocab = logits.shape
    if tuple(lse.shape) != (rows,) or lse.dtype != torch.float32 or lse.device != logits.device:
        raise ValueError(f"ts_cross_entropy_bwd takes the forward's f32 ({rows},) lse; got {tuple(lse.shape)} {lse.dtype}")
    if grad.numel() != 1 or grad.device != logits.device:
        raise ValueError(f"ts_cross_entropy_bwd takes a one-element gradient on the card; got {tuple(grad.shape)}")
    targets, lse = targets.contiguous(), lse.contiguous()
    grad = grad.to(torch.float32).contiguous()
    dlogits = torch.empty_like(logits)
    err = _library().ts_cross_entropy_bwd(
        logits.data_ptr(), targets.data_ptr(), lse.data_ptr(), grad.data_ptr(), dlogits.data_ptr(),
        rows, vocab, _divisor(rows, reduction), logits.device.index,
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _raise_on(err, "cross_entropy_bwd")
    launch_counts["cross_entropy_bwd"] += 1
    return dlogits


def _on_kernels(logits: torch.Tensor) -> bool:
    """The route: bf16 on a card takes the kernels, anything else the plain
    version."""
    return logits.device.type == "cuda" and logits.dtype == torch.bfloat16


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, reduction):
        loss, lse = cross_entropy_fwd(logits, targets, reduction)
        ctx.save_for_backward(logits, targets, lse)
        ctx.reduction = reduction
        return loss

    @staticmethod
    def backward(ctx, grad):
        logits, targets, lse = ctx.saved_tensors
        return cross_entropy_bwd(logits, targets, lse, grad, ctx.reduction), None, None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """The f32 cross-entropy of ``logits`` ``(rows, V)`` against integer
    ``targets`` ``(rows,)``, the mean or the sum over rows; differentiable
    in ``logits``, whose gradient comes back in their dtype."""
    if reduction not in REDUCTIONS:
        raise ValueError(f"reduction must be one of {REDUCTIONS}, got {reduction!r}")
    kernel = _on_kernels(logits)
    if kernel:
        loss = _CrossEntropy.apply(logits, targets, reduction)
    else:
        loss = cross_entropy_plain(logits, targets, reduction)
    telemetry.metrics().counter_inc(names.LOSS_ROWS_TOTAL, logits.shape[0], route="kernel" if kernel else "plain")
    return loss
