"""The port's low-precision codecs (``torchsnapshot_tpu_torch/lowp.py``):
a port, case for case, of the JAX package's ``tests/test_lowp.py`` on
torch tensors made from numpy seeds, on the CPU. The cross-package byte
identity is held in ``test_torch_bridge_crosspkg.py``."""

import struct

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import lowp

_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


def _t(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr))


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_per_tensor_roundtrip_error_bound(dtype) -> None:
    rng = np.random.default_rng(0)
    x = _t((rng.standard_normal((64, 33)) * 3).astype(np.float32)).to(_DTYPES[dtype])
    buf = lowp.encode_per_tensor(x)
    assert len(buf) == x.numel() + 16
    out = lowp.decode_per_tensor(buf, x.shape, device="cpu")
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    xf = x.float()
    span = float(xf.max() - xf.min())
    # Affine int8: max error is half a quantization step.
    assert float((out - xf).abs().max()) <= span / 255 + 1e-6


def test_per_tensor_zero_exactness() -> None:
    x = torch.zeros(10, 10)
    x[3, 4] = 5.0
    out = lowp.decode_per_tensor(lowp.encode_per_tensor(x), x.shape, device="cpu")
    assert bool((out[x == 0.0] == 0.0).all())


def test_per_tensor_constant_array() -> None:
    x = torch.full((7,), 2.5)
    out = lowp.decode_per_tensor(lowp.encode_per_tensor(x), x.shape, device="cpu")
    assert float((out - x).abs().max()) <= (2.5 / 255) + 1e-6


def test_per_tensor_wrong_size_raises() -> None:
    with pytest.raises(ValueError, match="bytes"):
        lowp.decode_per_tensor(b"\x00" * 10, (64,), device="cpu")


def test_per_tensor_rejects_int_arrays() -> None:
    with pytest.raises(ValueError, match="float"):
        lowp.encode_per_tensor(torch.arange(10, dtype=torch.int32))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_per_channel_roundtrip(axis) -> None:
    rng = np.random.default_rng(1)
    # Per-channel shines when channel ranges differ wildly.
    arr = rng.standard_normal((8, 16, 4)).astype(np.float32)
    scale_per_c = 10.0 ** np.arange(arr.shape[axis])
    arr = np.moveaxis(np.moveaxis(arr, axis, 0) * scale_per_c[:, None, None], 0, axis).astype(np.float32)
    x = _t(arr)
    buf = lowp.encode_per_channel(x, axis)
    out = lowp.decode_per_channel(buf, x.shape, device="cpu").numpy()
    moved_in = np.moveaxis(arr, axis, 0)
    moved_out = np.moveaxis(out, axis, 0)
    for c in range(moved_in.shape[0]):
        span = float(np.max(moved_in[c]) - np.min(moved_in[c]))
        span = max(span, abs(float(np.max(moved_in[c]))), 1e-6)
        assert np.max(np.abs(moved_out[c] - moved_in[c])) <= span / 255 + 1e-6


def test_per_channel_beats_per_tensor_on_mixed_scales() -> None:
    rng = np.random.default_rng(2)
    x = _t(np.stack([rng.standard_normal(256) * s for s in (0.01, 100.0)]).astype(np.float32))
    pt = lowp.decode_per_tensor(lowp.encode_per_tensor(x), x.shape, device="cpu")
    pc = lowp.decode_per_channel(lowp.encode_per_channel(x, 0), x.shape, device="cpu")
    err_pt = float((pt[0] - x[0]).abs().max())  # small-scale channel suffers
    err_pc = float((pc[0] - x[0]).abs().max())
    assert err_pc < err_pt / 100


def test_per_channel_layout_is_documented_format() -> None:
    x = torch.ones(2, 3)
    buf = lowp.encode_per_channel(x, 1)
    (axis,) = struct.unpack("<q", buf[:8])
    assert axis == 1
    assert len(buf) == 8 + x.numel() + 3 * 16


def test_per_channel_bad_axis_raises() -> None:
    with pytest.raises(ValueError, match="axis"):
        lowp.quantize_per_channel(torch.ones(2, 2), 5)


def test_decode_defaults_to_the_card() -> None:
    """Decoding produces a tensor, so it lands on the card unless the
    caller asks for the CPU; without a card that raises."""
    buf = lowp.encode_per_tensor(torch.ones(4))
    if torch.cuda.is_available():
        assert lowp.decode_per_tensor(buf, (4,)).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lowp.decode_per_tensor(buf, (4,))


def test_quantize_keeps_the_input_device_and_empty_axis_raises() -> None:
    q, scale, zp = lowp.quantize_per_tensor(torch.zeros(0))
    assert q.numel() == 0 and (scale, zp) == (1.0, 0)
    q, scales, zps = lowp.quantize_per_channel(torch.zeros(3, 0), 0)
    assert q.shape == (3, 0) and scales.tolist() == [1.0] * 3 and zps.tolist() == [0] * 3
    with pytest.raises(ValueError, match="empty axis"):
        lowp.quantize_per_channel(torch.zeros(3, 0), 1)
