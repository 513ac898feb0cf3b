"""Low-precision (affine int8) codecs for float tensors.

Counterpart of ``torchsnapshot_tpu/lowp.py`` over torch tensors on any
device, with the same bytes: an encoding made here decodes with the JAX
package's codec and the other way round. An opt-in storage transform for
float tensors (f32/bf16/f16/f64): encode to int8 with affine (scale,
zero_point) parameters, cutting checkpoint bytes 2-4x at the cost of
quantization error.

Binary layouts (all little-endian, the JAX package's)::

    per tensor:  int8 storage (N bytes) ‖ scale (float64) ‖ zero_point (int64)
    per channel: axis (int64) ‖ int8 storage (N bytes)
                 ‖ scales (float64 × C) ‖ zero_points (int64 × C)

where C = shape[axis]. Decoding returns float32 (the dequantized values).

What keeps the bytes the JAX package's:

- the parameters are computed as it computes them: float64 scales from
  the f32 minimum and maximum, with 0 exactly representable, and Python's
  ``round`` (half to even) for the per-tensor zero point; the per-channel
  ones from the channels' f32 minima and maxima on the host, by the same
  numpy expressions;
- the quantization is f32 arithmetic, ``round(x / scale) + zp`` with
  half-to-even rounding (``torch.round``, as ``np.round``). The divisor is
  a tensor on ``x``'s device: CUDA divides by a CPU scalar as a
  multiplication by its reciprocal, which moves some quotients by an ulp
  and flips some int8 codes.
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple

import numpy as np
import torch

from .utils.device import Device, resolve_device

_QMIN, _QMAX = -128, 127

_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)

_TAIL = struct.calcsize("<dq")
_HEAD = struct.calcsize("<q")


def _check_float(t: torch.Tensor) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"low-precision codecs take torch tensors; got {type(t).__name__}")
    if t.dtype not in _FLOAT_DTYPES:
        name = str(t.dtype).replace("torch.", "")
        raise ValueError(f"low-precision codecs quantize float arrays; got dtype {name}")
    return t.detach().to(torch.float32).contiguous()


def _affine_params(x: torch.Tensor) -> Tuple[float, int]:
    """(scale, zero_point) covering [min(x), max(x)] with 0 exactly
    representable (so sparse/zero-padded weights round-trip zeros)."""
    if x.numel():
        lo_t, hi_t = torch.aminmax(x)
        lo, hi = float(lo_t), float(hi_t)
    else:
        lo = hi = 0.0
    lo = min(lo, 0.0)
    hi = max(hi, 0.0)
    if hi == lo:
        return 1.0, 0
    scale = (hi - lo) / (_QMAX - _QMIN)
    zero_point = int(round(_QMIN - lo / scale))
    zero_point = max(_QMIN, min(_QMAX, zero_point))
    return scale, zero_point


def _f32(value, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def quantize_per_tensor(t: torch.Tensor) -> Tuple[torch.Tensor, float, int]:
    x = _check_float(t)
    scale, zp = _affine_params(x)
    q = torch.round(x / _f32(scale, x.device)).add_(_f32(zp, x.device))
    return q.clamp_(_QMIN, _QMAX).to(torch.int8), scale, zp


def dequantize_per_tensor(q: torch.Tensor, scale: float, zero_point: int) -> torch.Tensor:
    return (q.to(torch.float32) - _f32(zero_point, q.device)) * _f32(scale, q.device)


def _int8_bytes(q: torch.Tensor) -> bytes:
    return q.contiguous().cpu().numpy().tobytes()


def encode_per_tensor(t: torch.Tensor) -> bytes:
    q, scale, zp = quantize_per_tensor(t)
    return _int8_bytes(q) + struct.pack("<dq", scale, zp)


def _int8_tensor(mv: memoryview, shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    q = torch.frombuffer(bytearray(mv), dtype=torch.int8) if mv.nbytes else torch.empty(0, dtype=torch.int8)
    return q.reshape(shape).to(device)


def decode_per_tensor(
    buf: "bytes | memoryview", shape: Sequence[int], device: Device = None
) -> torch.Tensor:
    """The dequantized f32 tensor, on ``device`` (the card by default)."""
    device = resolve_device(device)
    mv = memoryview(buf).cast("B")
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if mv.nbytes != n + _TAIL:
        raise ValueError(
            f"per-tensor q8 buffer has {mv.nbytes} bytes; shape "
            f"{shape} needs {n} + {_TAIL}"
        )
    scale, zp = struct.unpack("<dq", mv[n:])
    return dequantize_per_tensor(_int8_tensor(mv[:n], shape, device), scale, zp)


def quantize_per_channel(
    t: torch.Tensor, axis: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(int8 codes on ``t``'s device, float64 scales, int64 zero points);
    the parameters are on ``t``'s device too."""
    x = _check_float(t)
    if not -x.ndim <= axis < x.ndim:
        raise ValueError(f"axis {axis} out of range for rank {x.ndim}")
    axis %= x.ndim
    moved = x.movedim(axis, 0)
    if moved.shape[0] == 0:
        raise ValueError(f"cannot quantize shape {tuple(x.shape)} per channel along its empty axis {axis}")
    flat = moved.reshape(moved.shape[0], -1)
    if flat.numel():
        mins, maxs = torch.aminmax(flat, dim=1)
        lo = np.minimum(mins.cpu().numpy(), 0.0).astype(np.float64)
        hi = np.maximum(maxs.cpu().numpy(), 0.0).astype(np.float64)
    else:
        lo = np.zeros(flat.shape[0], dtype=np.float64)
        hi = np.zeros(flat.shape[0], dtype=np.float64)
    degenerate = hi == lo
    scales = np.where(degenerate, 1.0, (hi - lo) / (_QMAX - _QMIN))
    zps = np.where(
        degenerate,
        0,
        np.clip(np.round(_QMIN - lo / scales), _QMIN, _QMAX),
    ).astype(np.int64)
    s32 = torch.from_numpy(scales.astype(np.float32)).to(x.device)[:, None]
    z32 = torch.from_numpy(zps.astype(np.float32)).to(x.device)[:, None]
    qflat = torch.round(flat / s32).add_(z32).clamp_(_QMIN, _QMAX).to(torch.int8)
    q = qflat.reshape(moved.shape).movedim(0, axis)
    return (
        q,
        torch.from_numpy(scales).to(x.device),
        torch.from_numpy(zps).to(x.device),
    )


def dequantize_per_channel(
    q: torch.Tensor, scales: torch.Tensor, zero_points: torch.Tensor, axis: int
) -> torch.Tensor:
    axis %= q.ndim
    bshape = [1] * q.ndim
    bshape[axis] = -1
    s = torch.as_tensor(scales).to(device=q.device, dtype=torch.float32).reshape(bshape)
    z = torch.as_tensor(zero_points).to(device=q.device, dtype=torch.float32).reshape(bshape)
    return (q.to(torch.float32) - z) * s


def encode_per_channel(t: torch.Tensor, axis: int) -> bytes:
    q, scales, zps = quantize_per_channel(t, axis)
    axis %= t.ndim
    return (
        struct.pack("<q", axis)
        + _int8_bytes(q)
        + scales.cpu().numpy().astype("<f8").tobytes()
        + zps.cpu().numpy().astype("<i8").tobytes()
    )


def decode_per_channel(
    buf: "bytes | memoryview", shape: Sequence[int], device: Device = None
) -> torch.Tensor:
    """The dequantized f32 tensor, on ``device`` (the card by default)."""
    device = resolve_device(device)
    mv = memoryview(buf).cast("B")
    if mv.nbytes < _HEAD:
        raise ValueError(
            f"per-channel q8 buffer has {mv.nbytes} bytes; too short for "
            f"the {_HEAD}-byte axis header"
        )
    (axis,) = struct.unpack("<q", mv[:_HEAD])
    shape = tuple(int(d) for d in shape)
    if not 0 <= axis < len(shape):
        raise ValueError(f"encoded axis {axis} invalid for shape {shape}")
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    c = shape[axis]
    expected = _HEAD + n + c * (8 + 8)
    if mv.nbytes != expected:
        raise ValueError(
            f"per-channel q8 buffer has {mv.nbytes} bytes; shape {shape} "
            f"axis {axis} needs {expected}"
        )
    q = _int8_tensor(mv[_HEAD : _HEAD + n], shape, device)
    scales = np.frombuffer(mv[_HEAD + n : _HEAD + n + 8 * c], dtype="<f8")
    zps = np.frombuffer(mv[_HEAD + n + 8 * c :], dtype="<i8")
    return dequantize_per_channel(q, torch.from_numpy(scales.copy()), torch.from_numpy(zps.copy()), axis)


__all__ = [
    "quantize_per_tensor",
    "dequantize_per_tensor",
    "encode_per_tensor",
    "decode_per_tensor",
    "quantize_per_channel",
    "dequantize_per_channel",
    "encode_per_channel",
    "decode_per_channel",
]
