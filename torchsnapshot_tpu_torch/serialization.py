"""Zero-copy (de)serialization between host tensors and byte buffers.

Counterpart of ``torchsnapshot_tpu/serialization.py``. The dtype strings are
the JAX package's, spelled exactly the same, so a snapshot written by either
package names its dtypes identically in the manifest. Three of them
(``float8_e4m3b11fnuz``, ``int4``, ``uint4``) have no torch dtype: this
package refuses to write them and cannot read them, with an error that says
so.

Byte export goes through ``tensor.view(torch.uint8)`` (a view, no copy) and
its numpy alias, which the buffer protocol understands for every dtype,
bfloat16 and the fp8 formats included. All buffers are little-endian on
disk; a big-endian host is rejected loudly.
"""

from __future__ import annotations

import pickle
import sys
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

if sys.byteorder != "little":  # pragma: no cover - every supported host is LE
    raise RuntimeError(
        "torchsnapshot_tpu_torch serializes buffers little-endian and requires "
        "a little-endian host."
    )


class Serializer(Enum):
    """How a leaf's bytes were produced (the JAX package's values)."""

    BUFFER_PROTOCOL = "buffer_protocol"
    PICKLE = "pickle"


# The JAX package's exhaustive dtype table (serialization.py:47-69), in its
# order; support is a conscious decision per dtype.
_SUPPORTED_DTYPE_NAMES: List[str] = [
    "bool",
    "int8",
    "int16",
    "int32",
    "int64",
    "uint8",
    "uint16",
    "uint32",
    "uint64",
    "float16",
    "bfloat16",
    "float32",
    "float64",
    "complex64",
    "complex128",
    "float8_e4m3fn",
    "float8_e5m2",
    "float8_e4m3b11fnuz",
    "int4",
    "uint4",
]

# Names in the table that torch has no dtype for: one byte per element on
# disk (ml_dtypes byte-packs int4/uint4), refused on write and on read.
NO_TORCH_DTYPE: Dict[str, int] = {"float8_e4m3b11fnuz": 1, "int4": 1, "uint4": 1}

STRING_TO_DTYPE: Dict[str, torch.dtype] = {
    name: getattr(torch, name)
    for name in _SUPPORTED_DTYPE_NAMES
    if name not in NO_TORCH_DTYPE
}
DTYPE_TO_STRING: Dict[torch.dtype, str] = {v: k for k, v in STRING_TO_DTYPE.items()}


def _no_torch_dtype_error(name: str) -> ValueError:
    return ValueError(
        f"dtype {name!r} has no torch counterpart; torchsnapshot_tpu_torch "
        f"can neither write nor read it (torchsnapshot_tpu can)"
    )


def dtype_to_string(dtype: torch.dtype) -> str:
    """Canonical string for a torch dtype. Raises on unsupported dtypes."""
    try:
        return DTYPE_TO_STRING[dtype]
    except KeyError:
        raise ValueError(
            f"Unsupported dtype for checkpointing: {dtype!r}. "
            f"Supported: {sorted(STRING_TO_DTYPE)}"
        ) from None


def string_to_dtype(s: str) -> torch.dtype:
    if s in NO_TORCH_DTYPE:
        raise _no_torch_dtype_error(s)
    try:
        return STRING_TO_DTYPE[s]
    except KeyError:
        raise ValueError(
            f"Unknown dtype string {s!r} in snapshot metadata. "
            f"Supported: {sorted(STRING_TO_DTYPE)}"
        ) from None


def dtype_size_bytes(s: str) -> int:
    if s in NO_TORCH_DTYPE:
        return NO_TORCH_DTYPE[s]
    return string_to_dtype(s).itemsize


def array_size_bytes(shape: Sequence[int], dtype_str: str) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype_size_bytes(dtype_str)


def _byte_array(t: torch.Tensor) -> np.ndarray:
    """The uint8 numpy alias of a contiguous CPU tensor's bytes."""
    return t.reshape(-1).view(torch.uint8).numpy()


def tensor_as_memoryview(t: torch.Tensor) -> memoryview:
    """Zero-copy export of a contiguous CPU tensor's bytes as a flat
    ``B``-format memoryview (callers stage contiguity and host residency
    first, where the copy is accounted against the memory budget)."""
    if t.device.type != "cpu":
        raise ValueError(f"tensor_as_memoryview needs a CPU tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(
            "tensor_as_memoryview requires a contiguous tensor; stage a "
            "contiguous copy first"
        )
    dtype_to_string(t.dtype)  # raises on unsupported dtypes
    if t.numel() == 0:
        return memoryview(b"")
    return memoryview(_byte_array(t))


def try_writable_byte_view(t: Any) -> Optional[memoryview]:
    """A writable byte view of ``t``, or ``None`` when it can't serve as a
    direct read destination (not a contiguous, non-empty CPU tensor of a
    supported dtype)."""
    if (
        not isinstance(t, torch.Tensor)
        or t.device.type != "cpu"
        or t.numel() == 0
        or not t.is_contiguous()
        or t.dtype not in DTYPE_TO_STRING
    ):
        return None
    return memoryview(_byte_array(t))


def copy_bytes_into(dst: torch.Tensor, buf: Any) -> None:
    """Copy a buffer holding exactly ``dst``'s bytes into the contiguous CPU
    tensor ``dst``."""
    src = np.frombuffer(buf, dtype=np.uint8)
    out = _byte_array(dst)
    if src.nbytes != out.nbytes:
        raise ValueError(
            f"Buffer has {src.nbytes} bytes but the destination "
            f"({dst.dtype}, {tuple(dst.shape)}) needs {out.nbytes}"
        )
    np.copyto(out, src)


def empty_tensor(shape: Sequence[int], dtype: str, pin_memory: bool = False) -> torch.Tensor:
    return torch.empty(
        tuple(int(d) for d in shape),
        dtype=string_to_dtype(dtype),
        pin_memory=pin_memory,
    )


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor aliasing a numpy array's bytes (copied only when the
    array is not C-contiguous). Arrays of the ml_dtypes formats
    (bfloat16, fp8) carry over through their bytes; the three formats
    without a torch dtype are refused."""
    name = arr.dtype.name
    if name in NO_TORCH_DTYPE:
        raise _no_torch_dtype_error(name)
    dtype = string_to_dtype(name)
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return torch.from_numpy(raw).view(dtype).reshape(arr.shape)


def pickle_save_as_bytes(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=5)


def pickle_load_from_bytes(data: bytes) -> Any:
    return pickle.loads(data)


def obj_type_name(obj: Any) -> str:
    t = type(obj)
    mod = getattr(t, "__module__", "builtins")
    return f"{mod}.{t.__qualname__}" if mod != "builtins" else t.__qualname__
