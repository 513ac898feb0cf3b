"""torchsnapshot_tpu_torch: the PyTorch/CUDA port of torchsnapshot_tpu.

Checkpointing of torch training state (``nn.Module``, ``torch.optim``
optimizers, trees of tensors on the CPU or a CUDA card) with the snapshot
format of ``torchsnapshot_tpu``: either package restores what the other
writes. This package imports ``torch`` and never ``jax``.

What is ported so far: ``Snapshot.take`` and ``Snapshot.async_take``
(incremental through ``incremental_base=``, with content digests computed
on the card by a hand-written CUDA kernel), ``Snapshot.restore``,
``Snapshot.async_restore`` and ``Snapshot.read_object``, to a local
filesystem (or ``memory://``), in one process or across the ranks of a
process group (``pg=``, e.g. :func:`torch_process_group` in a
``torch.distributed`` job, with ``replicated=`` state written once); the
training loop around them, ``CheckpointManager`` (step-numbered saves,
retention, incremental chains, ``restore_latest``) and
``PreemptionSaver`` (a save on SIGTERM); ``fsck`` to audit what they
left on disk; sharded ``DTensor`` state and resharding, slab batching,
the content-addressed chunk store (``cas/``), tiered roots and the
peer-RAM tier (``tiered/``), the chaos engine (``chaos/``) and the
checkpoint CDN that streams committed steps to a serving fleet
(``cdn/``); plus the workload the benchmarks checkpoint, the
transformer of ``models/`` with its hand-written CUDA flash-attention
kernels (``ops/``, ``csrc/``).
"""

from . import telemetry
from .dist_store import ProcessGroup, torch_process_group
from .fsck import FsckReport, verify_snapshot
from .knobs import override_max_chunk_size_bytes, override_per_rank_memory_budget_bytes
from .manager import CheckpointManager
from .preemption import PreemptionSaver
from .rng_state import RngState, RNGState
from .snapshot import PendingRestore, PendingSnapshot, Snapshot
from .state_dict import StateDict, TensorTreeState
from .stateful import AppState, Stateful
from .version import __version__

__all__ = [
    "AppState",
    "CheckpointManager",
    "FsckReport",
    "PendingRestore",
    "PendingSnapshot",
    "PreemptionSaver",
    "ProcessGroup",
    "RngState",
    "RNGState",
    "Snapshot",
    "StateDict",
    "Stateful",
    "TensorTreeState",
    "__version__",
    "override_max_chunk_size_bytes",
    "override_per_rank_memory_budget_bytes",
    "telemetry",
    "torch_process_group",
    "verify_snapshot",
]
