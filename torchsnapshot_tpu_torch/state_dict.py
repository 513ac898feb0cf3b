"""Stateful adapters for plain values and trees of tensors.

Counterpart of ``torchsnapshot_tpu/state_dict.py``. A JAX pytree is
immutable, so the JAX package's ``PyTreeState`` swaps the whole tree on
restore. Torch state is mutable, and restore writes into the live tensors:

- ``torch.nn.Module`` and ``torch.optim.Optimizer`` are ``Stateful`` as
  they are. Their ``state_dict()`` tensors share storage with the live
  parameters and optimizer state, so ``Snapshot.restore`` copies into them
  in place and their own ``load_state_dict`` then applies the rest
  (hyperparameters, step counters).
- :class:`TensorTreeState` adapts a dict tree of tensors and plain
  values (what ``PyTreeState`` holds in the JAX package): tensors are
  restored in place, everything else is replaced.
"""

from __future__ import annotations

from collections import UserDict
from typing import Any, Dict

import torch


class StateDict(UserDict):
    """Dict wrapper that makes plain values participate in checkpointing.

    ``state_dict()`` returns the underlying data; ``load_state_dict``
    replaces it wholesale.
    """

    def state_dict(self) -> Dict[str, Any]:
        return self.data

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.data = dict(state_dict)


def load_tree_into(live: Any, restored: Any) -> Any:
    """Merge ``restored`` into ``live``: a tensor present in both is copied
    into the live tensor (a no-op when restore already wrote into it);
    containers are merged key by key; any other value is replaced. Returns
    the merged tree, whose tensors are the live ones."""
    if isinstance(live, torch.Tensor) and isinstance(restored, torch.Tensor):
        if restored is not live:
            if restored.shape != live.shape:
                raise ValueError(
                    f"cannot restore shape {tuple(restored.shape)} into a live "
                    f"tensor of shape {tuple(live.shape)}"
                )
            with torch.no_grad():
                live.copy_(restored)
        return live
    if isinstance(live, dict) and isinstance(restored, dict):
        for key, value in restored.items():
            live[key] = load_tree_into(live[key], value) if key in live else value
        return live
    if isinstance(live, list) and isinstance(restored, list) and len(live) == len(restored):
        live[:] = [load_tree_into(a, b) for a, b in zip(live, restored)]
        return live
    return restored


class TensorTreeState:
    """Adapt a dict tree of tensors and plain values (dicts and lists
    nested) into the ``Stateful`` protocol, restoring tensors in place.

    Usage::

        app_state = {"params": TensorTreeState({"w": w, "layers": [...]})}
        Snapshot.take(path, app_state)
        ...
        Snapshot(path).restore(app_state)   # w and the layers' tensors updated
    """

    def __init__(self, tree: Dict[str, Any]) -> None:
        if not isinstance(tree, dict):
            raise TypeError(f"TensorTreeState holds a dict tree, got {type(tree)}")
        self.tree = tree

    def state_dict(self) -> Dict[str, Any]:
        return self.tree

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.tree = load_tree_into(self.tree, state_dict)
