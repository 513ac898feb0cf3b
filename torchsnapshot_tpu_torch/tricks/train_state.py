"""``TrainStateStateful``: a training job's model and optimizers as one
``Stateful``, in the names of ``torch.distributed.checkpoint.state_dict``.

Counterpart of ``torchsnapshot_tpu/tricks/flax.py``, which adapts a flax
``TrainState`` (params, optimizer state, step) to the Stateful protocol.
The torch train state is a module and its optimizers; torch's own adapter
for them is ``get_state_dict`` / ``set_state_dict``: state keyed by
parameter names (fully qualified names, dots included), ``DTensor``
parameters and their sharded moments included, the optimizers' state made
if they have taken no step yet. The step goes beside them. Nothing that is
not state is saved: no module or optimizer objects, no closures.

Usage::

    tss = TrainStateStateful(model, optimizer, step=step)
    Snapshot.take(path, {"train": tss})          # or dcp.save({"train": tss}, ...)
    ...
    Snapshot(path).restore({"train": tss})       # model and optimizer in place
    step = tss.step
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Union

import torch


def _require(obj: Any, what: str) -> None:
    for field in ("state_dict", "load_state_dict"):
        if not callable(getattr(obj, field, None)):
            raise TypeError(
                f"{type(obj).__name__} has no {field!r}; TrainStateStateful expects "
                f"{what} with state_dict() and load_state_dict()"
            )


class TrainStateStateful:
    """Adapt ``model`` (an ``nn.Module``), ``optimizers`` (one optimizer or
    several over its parameters) and ``step`` to the Stateful protocol.
    ``state_dict()`` is ``{"model": ..., "optim": ..., "step": ...}`` from
    ``get_state_dict``; ``load_state_dict()`` applies it in place with
    ``set_state_dict`` and takes the step back."""

    def __init__(
        self,
        model: torch.nn.Module,
        optimizers: Union[torch.optim.Optimizer, Sequence[torch.optim.Optimizer]],
        step: int = 0,
    ) -> None:
        _require(model, "a model")
        optims = list(optimizers) if isinstance(optimizers, (list, tuple)) else [optimizers]
        for optim in optims:
            _require(optim, "an optimizer")
        self.model = model
        self.optimizers = optims
        self.step = step

    def state_dict(self) -> Dict[str, Any]:
        from torch.distributed.checkpoint.state_dict import get_state_dict

        model_sd, optim_sd = get_state_dict(self.model, self.optimizers)
        return {"model": model_sd, "optim": optim_sd, "step": self.step}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        from torch.distributed.checkpoint.state_dict import set_state_dict

        set_state_dict(
            self.model, self.optimizers,
            model_state_dict=state_dict["model"], optim_state_dict=state_dict["optim"],
        )
        self.step = int(state_dict["step"])
