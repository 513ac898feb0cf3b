"""Pipeline parallelism: a GPipe schedule over a ``pp`` device-mesh dimension.

Counterpart of ``torchsnapshot_tpu/parallel/pipeline.py``: the one state
layout a flagship model alone never produces, stage-stacked leaves
sharded over a ``pp`` dimension, and the schedule that trains them.

- Stage parameters are ONE stacked tree: every leaf gains a leading
  ``n_stages`` dim, a ``DTensor`` ``Shard(0)`` over ``pp`` when a mesh is
  given (:func:`stack_stage_params`; each rank stacks only its own stages,
  the full stack never exists on one rank). For the checkpointer it is
  another sharded ``DTensor``: each rank writes its stages' boxes, and a
  restore into another pp degree reshards the stage dim.
- :func:`pipelined_apply` runs the JAX module's trapezoid,
  ``n_microbatches + n_stages - 1`` ticks: at tick ``t`` rank ``r``
  computes microbatch ``t - r``, then the activations hop ``r -> r + 1``
  around the ring (JAX's ``lax.ppermute``), one ``batch_isend_irecv``
  pair on the ``pp`` group. The last stage's outputs are then broadcast
  to every rank (JAX's masked ``psum``). A bubble tick passes its input
  through instead of computing on it: its result never reaches the
  output, so JAX's computation of it changes nothing but the time.
- The schedule is differentiable. A hop is an ``autograd.Function`` whose
  backward hops the cotangent the other way (the transpose of
  ``ppermute``). Every rank computes the same loss on the replicated
  output, so the broadcast's backward keeps the last rank's cotangent and
  gives the others zero, and the input's backward sums the ranks'
  cotangents (only stage 0's is not zero): no gradient is scaled by the
  number of stages. Each rank's backward runs the hops in reverse tick
  order (each hop's cotangent needs the next tick's), so the ranks' sends
  and receives pair up without tags.

Transport: on an NCCL group a CUDA tensor is sent as it is. On a gloo
group (the only one that holds two ranks on one card, and the CPU tests')
a CUDA tensor goes to the host and back explicitly; :func:`transport`
names the route. Every move (a hop, the output's broadcast, the input
cotangent's sum) counts in the telemetry registry:
``PIPELINE_TRANSFERS_TOTAL``, ``PIPELINE_TRANSFER_BYTES_TOTAL`` and
``PIPELINE_TRANSFER_SECONDS_TOTAL`` by ``kind``, and a host round trip's
bytes in the device-copy counters. Ring attention (``ops/ring_attention.py``)
and the sequence-parallel step reuse :class:`_Ring` (kinds ``ring`` and
``sp_sum``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .. import telemetry
from ..telemetry import names as metric_names

StageFn = Callable[[Any, torch.Tensor], torch.Tensor]


def _mesh_dim(mesh: Any, axis_name: str) -> int:
    names = mesh.mesh_dim_names
    if not names or axis_name not in names:
        raise ValueError(f"the device mesh has no dimension named {axis_name!r} (its names: {names})")
    return names.index(axis_name)


def _stage_placements(mesh: Any, axis_name: str) -> list:
    from torch.distributed.tensor import Replicate, Shard

    dim = _mesh_dim(mesh, axis_name)
    return [Shard(0) if i == dim else Replicate() for i in range(mesh.ndim)]


def stack_stage_params(per_stage: List[Any], mesh: Optional[Any] = None) -> Any:
    """Stack per-stage parameter trees into one tree whose leaves have a
    leading ``n_stages`` dim; with a ``DeviceMesh``, each leaf is a
    ``DTensor`` ``Shard(0)`` over its ``pp`` dimension built from this
    rank's stages alone (no collective)."""
    flat = [tree_flatten(tree) for tree in per_stage]
    spec = flat[0][1]
    if any(s != spec for _, s in flat[1:]):
        raise ValueError("the per-stage trees differ in structure; they cannot stack")
    columns = list(zip(*(leaves for leaves, _ in flat)))
    if mesh is None:
        return tree_unflatten([torch.stack(col) for col in columns], spec)
    from torch.distributed.tensor import DTensor

    from ..resharding import mesh_box

    placements = _stage_placements(mesh, "pp")
    out = []
    for col in columns:
        shape = (len(col), *col[0].shape)
        box = mesh_box(mesh, placements, shape)[0]
        lo, k = box.offsets[0], box.sizes[0]
        local = torch.stack(col[lo:lo + k]) if k else col[0].new_empty((0, *col[0].shape))
        full = torch.empty(shape, device="meta")  # the global shape's contiguous strides
        out.append(DTensor.from_local(
            local, mesh, placements, run_check=False, shape=full.shape, stride=full.stride()
        ))
    return tree_unflatten(out, spec)


def pipeline_stage_shardings(stage_params: Any, mesh: Any, axis_name: str = "pp") -> Any:
    """Per leaf, the ``(DeviceMesh, placements)`` of stacked stage params:
    the restore destinations ``read_object(sharding=)`` and ``DTensor``
    restores take."""
    placements = _stage_placements(mesh, axis_name)
    return tree_map(lambda _: (mesh, list(placements)), stage_params)


def transport(group: Any, device: torch.device) -> str:
    """How a hop on ``group`` moves a tensor on ``device``."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"an NCCL pp group moves CUDA tensors only, not {device.type} ones")
        return "nccl"
    return "gloo via host" if device.type == "cuda" else backend


class _Ring:
    """The ``pp`` group as a ring: this rank's coordinate, its peers'
    global ranks, and the moves of one tensor."""

    def __init__(self, mesh: Any, axis_name: str) -> None:
        dim = _mesh_dim(mesh, axis_name)
        self.n = mesh.size(dim)
        self.r = mesh.get_local_rank(dim)
        self.group = mesh.get_group(dim) if self.n > 1 else None
        self.ranks = [dist.get_global_rank(self.group, i) for i in range(self.n)] if self.n > 1 else []

    def _counted(self, kind: str, t: torch.Tensor, move: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """``move`` of ``t`` (through the host on gloo), counted."""
        t0 = time.perf_counter()
        host = transport(self.group, t.device) == "gloo via host"
        buf = t.detach().contiguous()
        nbytes = buf.numel() * buf.element_size()
        registry = telemetry.metrics()
        if host:
            torch.cuda.current_stream(t.device).synchronize()
            buf = buf.cpu()
            registry.counter_inc(metric_names.DEVICE_TO_HOST_BYTES_TOTAL, nbytes)
        got = move(buf)
        if host:
            got = got.to(t.device)
            torch.cuda.current_stream(t.device).synchronize()
            registry.counter_inc(metric_names.HOST_TO_DEVICE_BYTES_TOTAL, got.numel() * got.element_size())
        registry.counter_inc(metric_names.PIPELINE_TRANSFERS_TOTAL, 1, kind=kind)
        registry.counter_inc(metric_names.PIPELINE_TRANSFER_BYTES_TOTAL, nbytes, kind=kind)
        registry.counter_inc(metric_names.PIPELINE_TRANSFER_SECONDS_TOTAL, time.perf_counter() - t0, kind=kind)
        return got

    def shift(self, t: torch.Tensor, k: int, kind: str = "hop") -> torch.Tensor:
        """Send ``t`` to ring neighbour ``r + k``; return what ``r - k``
        sent (``t``'s shape and dtype). ``kind`` labels the move's
        counters."""
        if self.n == 1:
            return t.detach().clone()

        def move(buf: torch.Tensor) -> torch.Tensor:
            got = torch.empty_like(buf)
            ops = [
                dist.P2POp(dist.isend, buf, self.ranks[(self.r + k) % self.n], self.group),
                dist.P2POp(dist.irecv, got, self.ranks[(self.r - k) % self.n], self.group),
            ]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            return got

        return self._counted(kind, t, move)

    def gather(self, t: torch.Tensor, kind: str = "gather") -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape and dtype on all), in ring order,
        on ``t``'s device."""
        if self.n == 1:
            return [t.detach().clone()]

        def move(buf: torch.Tensor) -> torch.Tensor:
            got = [torch.empty_like(buf) for _ in range(self.n)]
            dist.all_gather(got, buf, group=self.group)
            return torch.stack(got)

        return list(self._counted(kind, t, move).unbind(0))

    def broadcast_from_last(self, t: torch.Tensor) -> torch.Tensor:
        if self.n == 1:
            return t.detach().clone()

        def move(buf: torch.Tensor) -> torch.Tensor:
            buf = buf.clone()
            dist.broadcast(buf, self.ranks[-1], group=self.group)
            return buf

        return self._counted("broadcast", t, move)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.n == 1:
            return t

        def move(buf: torch.Tensor) -> torch.Tensor:
            buf = buf.clone()
            dist.all_reduce(buf, group=self.group)
            return buf

        return self._counted("sum", t, move)


class _Hop(torch.autograd.Function):
    """``r -> r + 1`` forward; the cotangent ``r + 1 -> r`` backward."""

    @staticmethod
    def forward(ctx: Any, y: torch.Tensor, ring: _Ring) -> torch.Tensor:
        ctx.ring = ring
        return ring.shift(y, 1)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return ctx.ring.shift(g, -1), None


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every rank. Every rank's loss sees the
    same values, and only the last rank's cotangent is the output's."""

    @staticmethod
    def forward(ctx: Any, out: torch.Tensor, ring: _Ring) -> torch.Tensor:
        ctx.last = ring.r == ring.n - 1
        return ring.broadcast_from_last(out)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return (g if ctx.last else torch.zeros_like(g)), None


class _IntoStages(torch.autograd.Function):
    """The input, replicated on every rank; only stage 0 reads it, so its
    cotangent is the sum of the ranks' (the others' are zero)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, ring: _Ring) -> torch.Tensor:
        ctx.ring = ring
        return x.view_as(x)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return ctx.ring.sum(g), None


def _stage_slice(p: torch.Tensor, r: int, n_stages: int) -> torch.Tensor:
    """This rank's stage of a stacked leaf: the local shard of a
    ``Shard(0)`` ``DTensor`` (differentiable into its ``.grad``), or row
    ``r`` of a full stack."""
    local = p.to_local() if hasattr(p, "device_mesh") else p
    return local[r] if local.shape[0] == n_stages else local[0]


def pipelined_apply(
    stage_fn: StageFn,
    stage_params: Any,
    x: torch.Tensor,
    *,
    mesh: Any,
    n_microbatches: int,
    axis_name: str = "pp",
) -> torch.Tensor:
    """Run ``x`` through ``n_stages`` copies of ``stage_fn`` as a GPipe
    pipeline over the mesh's ``axis_name`` dimension.

    Args:
        stage_fn: ``(params_for_one_stage, activation) -> activation``, the
            activation's shape preserved (embedding before and readout
            after the pipeline: the hopping tensor has one shape).
        stage_params: a stacked tree from :func:`stack_stage_params`
            (leaves ``(n_stages, ...)``, ``Shard(0)`` over ``axis_name``,
            or full stacks on every rank).
        x: ``(batch, ...)`` activations entering stage 0, the same on
            every rank; ``batch`` must divide by ``n_microbatches``.

    Returns:
        ``(batch, ...)`` output of the last stage, on every rank.
    """
    ring = _Ring(mesh, axis_name)
    n_stages = ring.n
    leaves = tree_flatten(stage_params)[0]
    if leaves and leaves[0].shape[0] != n_stages:
        # Each rank keeps only its slice's first stage: a mismatched
        # stacking would silently drop stages, not fail.
        raise ValueError(
            f"stage_params are stacked for {leaves[0].shape[0]} stages but "
            f"mesh axis {axis_name!r} has {n_stages} devices"
        )
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} must divide by n_microbatches={n_microbatches}")
    r = ring.r
    params = tree_map(lambda p: _stage_slice(p, r, n_stages), stage_params)
    xs = _IntoStages.apply(x, ring).reshape(n_microbatches, batch // n_microbatches, *x.shape[1:])
    # Stage 0 reads the input, the others the hop; a select (not a Python
    # branch) keeps stage 0's hops in its graph too. Bubble ticks pass
    # their input through: a leaf that requires grad keeps every rank's
    # hops in its backward graph, so that every rank runs every hop's
    # backward, in the same order.
    first = torch.full((), r == 0, device=x.device)
    act = torch.zeros_like(xs[0]).requires_grad_(torch.is_grad_enabled())
    outs = []
    n_ticks = n_microbatches + n_stages - 1
    for t in range(n_ticks):
        inp = torch.where(first, xs[min(t, n_microbatches - 1)], act)
        y = stage_fn(params, inp).to(x.dtype) if 0 <= t - r < n_microbatches else inp
        if t >= n_stages - 1:
            outs.append(y)  # the last stage finishes microbatch t - (n_stages - 1)
        if t < n_ticks - 1:
            act = _Hop.apply(y, ring)
    # Only the last stage's outputs are the model's: the broadcast
    # replaces the others' in the forward, and its backward gives them
    # zero cotangents.
    out = _FromLast.apply(torch.stack(outs), ring)
    return out.reshape(batch, *x.shape[1:])
