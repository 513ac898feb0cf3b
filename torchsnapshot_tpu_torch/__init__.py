"""torchsnapshot_tpu_torch: the PyTorch/CUDA port of torchsnapshot_tpu.

Checkpointing of torch training state (``nn.Module``, ``torch.optim``
optimizers, trees of tensors on the CPU or a CUDA card) with the snapshot
format of ``torchsnapshot_tpu``: either package restores what the other
writes. This package imports ``torch`` and never ``jax``.

What is ported so far is the one-process main path: ``Snapshot.take``,
``Snapshot.restore`` and ``Snapshot.read_object`` to a local filesystem
(or ``memory://``), plus the workload the benchmarks checkpoint, the
transformer of ``models/`` with its hand-written CUDA flash-attention
kernels (``ops/``, ``csrc/``).
"""

from . import telemetry
from .rng_state import RngState, RNGState
from .snapshot import Snapshot
from .state_dict import StateDict, TensorTreeState
from .stateful import AppState, Stateful
from .version import __version__

__all__ = [
    "AppState",
    "RngState",
    "RNGState",
    "Snapshot",
    "StateDict",
    "Stateful",
    "TensorTreeState",
    "__version__",
    "telemetry",
]
