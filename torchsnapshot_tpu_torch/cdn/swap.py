"""Hot weight swap: shadow-stage an announced step, then flip pointers.

Counterpart of ``torchsnapshot_tpu/cdn/swap.py``. The served tensors are
never mutated. ``stage`` assembles the announce's chunk bytes into a
complete *shadow* set on the host (pinned memory for every leaf bound for
a CUDA card), leaving the served weights untouched, so a subscriber
killed mid-stage (the ``cdn-swap-staged`` crash point) still serves the
previous fully applied step. ``swap`` then places the whole shadow set in
one batch per card and flips the dict:

- fresh tensors are allocated on a side CUDA stream and every copy is
  issued there from pinned memory (``non_blocking``), then one event is
  recorded;
- the serving stream (the caller's current stream on that card) waits on
  the event, so work queued after ``swap`` returns reads the new weights;
- the dict flips, and the old tensors are dropped after
  ``record_stream(serving)``: the caching allocator reuses their memory
  only once the forwards already queued on the serving stream are done.
  This is the JAX package's ``delete()``: peak device memory is old + new
  for the span between placement and the drop.

A ``DTensor`` leaf is placed as this rank's box of the assembled array
under the old leaf's mesh and placements (``DTensor.from_local(...,
run_check=False)``, no collective). CPU tensors stay on the CPU, and numpy
leaves swap as host arrays, as in the JAX package. A failed allocation or
copy raises, and the served weights stay the previous step's; a leaf on a
device that is neither the CPU nor a CUDA card raises.

The mapping from chunk bytes to leaves is the serving binary's knowledge,
injected as ``assemble(announce, chunk_bytes) -> {leaf: host array}``;
:func:`concat_assembler` covers the dense layout (chunks concatenated in
sorted-key order, sliced per template leaf) that the storm harness uses.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..sharded_io_preparer import _contiguous_stride, is_dtensor, local_tensor
from ..telemetry import names as metric_names
from ..telemetry.trace import get_recorder as _trace_recorder
from .topic import Announce

Assembler = Callable[[Announce, Dict[str, bytes]], Dict[str, Any]]


class SwapError(RuntimeError):
    """The assembled update does not cover the serving template, or could
    not be placed."""


def _leaf_spec(leaf: Any) -> Tuple[Tuple[int, ...], Any, int]:
    """``(shape, dtype, nbytes)`` of a template leaf: a torch dtype for a
    torch tensor (``DTensor``: its global shape), a numpy dtype otherwise."""
    if isinstance(leaf, torch.Tensor):
        shape = tuple(int(d) for d in leaf.shape)
        return shape, leaf.dtype, leaf.element_size() * int(np.prod(shape, dtype=np.int64))
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        shape, dtype = tuple(leaf.shape), np.dtype(leaf.dtype)
    else:
        arr = np.asarray(leaf)
        shape, dtype = arr.shape, arr.dtype
    return shape, dtype, dtype.itemsize * int(np.prod(shape, dtype=np.int64))


def _host_leaf(buf: bytearray, offset: int, shape: Tuple[int, ...], dtype: Any, nbytes: int) -> Any:
    """The ``nbytes`` at ``offset`` of ``buf`` as a host array of ``shape``
    and ``dtype``, without a copy: a CPU tensor for a torch dtype (bfloat16
    included, which numpy lacks), a numpy array otherwise."""
    if isinstance(dtype, torch.dtype):
        if nbytes == 0:
            return torch.empty(shape, dtype=dtype)
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=nbytes, offset=offset)
        return raw.view(dtype).reshape(shape)
    if nbytes == 0:
        return np.empty(shape, dtype=dtype)
    return np.frombuffer(buf, dtype=dtype, count=nbytes // dtype.itemsize, offset=offset).reshape(shape)


def concat_assembler(template: Dict[str, Any]) -> Assembler:
    """Assembler for the dense concat layout: the announce's chunks,
    concatenated in sorted-key order, are the template's leaves flattened
    in sorted-name order. Sizes are checked exactly: a short or long byte
    stream is a torn update and never stages."""
    # Shapes and dtypes are read now: after a swap the template's tensors
    # are gone from the served set, and reading them at assemble time
    # would tie every later update to the first weights.
    spec = [(name, *_leaf_spec(template[name])) for name in sorted(template)]

    def assemble(ann: Announce, chunk_bytes: Dict[str, bytes]) -> Dict[str, Any]:
        stream = bytearray().join(chunk_bytes[k] for k in sorted(chunk_bytes))
        out: Dict[str, Any] = {}
        offset = 0
        for name, shape, dtype, nbytes in spec:
            if offset + nbytes > len(stream):
                raise SwapError(
                    f"announced step covers {len(stream)} bytes; leaf {name!r} needs "
                    f"[{offset}, {offset + nbytes})"
                )
            out[name] = _host_leaf(stream, offset, shape, dtype, nbytes)
            offset += nbytes
        if offset != len(stream):
            raise SwapError(f"announced step has {len(stream) - offset} bytes past the template's layout")
        return out

    return assemble


class _StagedUpdate:
    """A fully assembled shadow set, not yet visible to serving. Torch
    leaves hold the host tensor to place: this rank's box for a
    ``DTensor``, in pinned memory when bound for a card."""

    __slots__ = ("announce", "host_arrays")

    def __init__(self, announce: Announce, host_arrays: Dict[str, Any]) -> None:
        self.announce = announce
        self.host_arrays = host_arrays


def _target_device(leaf: torch.Tensor) -> torch.device:
    device = local_tensor(leaf).device if is_dtensor(leaf) else leaf.device
    if device.type not in ("cpu", "cuda"):
        raise SwapError(f"cannot place a leaf on {device}: only the CPU and CUDA cards are supported")
    return device


def _as_host_tensor(name: str, value: Any, old: torch.Tensor) -> torch.Tensor:
    """``value`` as a CPU tensor of the old leaf's (global) shape and dtype."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value))
    if value.device.type != "cpu":
        raise SwapError(f"assembled leaf {name!r} is on {value.device}, not on the host")
    if tuple(value.shape) != tuple(old.shape) or value.dtype != old.dtype:
        raise SwapError(
            f"assembled leaf {name!r} is {value.dtype}{tuple(value.shape)}; the served leaf is "
            f"{old.dtype}{tuple(old.shape)}"
        )
    return value


def _stage_tensor(name: str, value: Any, old: torch.Tensor) -> torch.Tensor:
    """The host tensor ``swap`` places for one torch leaf: this rank's box
    of a ``DTensor``, copied into pinned memory for a card."""
    host = _as_host_tensor(name, value, old)
    if is_dtensor(old):
        from ..parallel.overlap import Box

        host = host[Box.from_dtensor(old).to_index()].contiguous()
    if _target_device(old).type != "cuda":
        return host
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned


def _wrap_like(old: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` as the new leaf: a ``DTensor`` under the old leaf's mesh
    and placements (no collective), or the tensor itself."""
    if not is_dtensor(old):
        return local
    from torch.distributed.tensor import DTensor

    shape = tuple(int(d) for d in old.shape)
    return DTensor.from_local(
        local, old.device_mesh, old.placements, run_check=False,
        shape=torch.Size(shape), stride=_contiguous_stride(shape),
    )


class WeightSwapper:
    """Serve one weight set; replace it whole per announce.

    ``weights`` is the served leaf map: torch tensors (on CUDA cards or
    the CPU, ``DTensor``s included) or numpy arrays. The caller serves
    from :attr:`weights` (``torch.func.functional_call(model,
    swapper.weights, ...)``) and holds no other reference to the old
    tensors, so that a swap frees them."""

    def __init__(self, weights: Dict[str, Any], assemble: Optional[Assembler] = None) -> None:
        self._weights = dict(weights)
        self._assemble = assemble if assemble is not None else concat_assembler(weights)
        # One side stream per card, reused by every swap.
        self._streams: Dict[torch.device, Any] = {}
        self.swapped_step: Optional[int] = None

    @property
    def weights(self) -> Dict[str, Any]:
        """The served leaf map (as of the last completed swap)."""
        return self._weights

    def stage(self, ann: Announce, chunk_bytes: Dict[str, bytes]) -> _StagedUpdate:
        host = self._assemble(ann, chunk_bytes)
        missing = set(self._weights) - set(host)
        if missing:
            raise SwapError(f"assembled update misses leaves: {sorted(missing)[:5]}")
        staged = dict(host)
        for name, old in self._weights.items():
            if isinstance(old, torch.Tensor):
                staged[name] = _stage_tensor(name, host[name], old)
        return _StagedUpdate(ann, staged)

    def _side_stream(self, device: torch.device) -> Any:
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        return stream

    def _place_on_card(self, device: torch.device, names: List[str], staged: _StagedUpdate) -> Dict[str, torch.Tensor]:
        """Copy the staged tensors of ``names`` to ``device`` in one batch:
        allocations and copies on the side stream, one event the serving
        stream waits on."""
        serving = torch.cuda.current_stream(device)
        side = self._side_stream(device)
        placed: Dict[str, torch.Tensor] = {}
        with torch.cuda.device(device), torch.cuda.stream(side):
            for name in names:
                src = staged.host_arrays[name]
                try:
                    dst = torch.empty(src.shape, dtype=src.dtype, device=device)
                    dst.copy_(src, non_blocking=True)
                except RuntimeError as e:
                    raise SwapError(f"placing leaf {name!r} on {device} failed: {e}") from e
                placed[name] = dst
            done = torch.cuda.Event()
            done.record(side)
        serving.wait_event(done)
        for dst in placed.values():
            # Allocated on the side stream, read on the serving stream.
            dst.record_stream(serving)
        return placed

    def swap(self, staged: _StagedUpdate) -> None:
        with _trace_recorder().span(
            metric_names.SPAN_CDN_SWAP, topic=staged.announce.topic, step=staged.announce.step
        ):
            old = self._weights
            torch_names = [n for n in sorted(staged.host_arrays) if isinstance(old.get(n), torch.Tensor)]
            by_device: Dict[torch.device, List[str]] = {}
            for name in torch_names:
                by_device.setdefault(_target_device(old[name]), []).append(name)
            locals_: Dict[str, torch.Tensor] = {}
            for device, names in by_device.items():
                if device.type == "cuda":
                    locals_.update(self._place_on_card(device, names, staged))
                else:
                    locals_.update((n, staged.host_arrays[n]) for n in names)
            fresh: Dict[str, Any] = dict(staged.host_arrays)
            for name, local in locals_.items():
                fresh[name] = _wrap_like(old[name], local)
            # The pointer flip is the cutover; everything before it left
            # the served set untouched.
            self._weights = fresh
            self.swapped_step = staged.announce.step
            for name in torch_names:
                prior = old[name]
                prior = local_tensor(prior) if is_dtensor(prior) else prior
                if prior.is_cuda:
                    # Forwards already queued on the serving stream may
                    # still read it: its memory is reused only after them.
                    prior.record_stream(torch.cuda.current_stream(prior.device))
            del old
