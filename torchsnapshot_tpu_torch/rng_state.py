"""RNG state capture for torch programs.

Counterpart of ``torchsnapshot_tpu/rng_state.py``, which holds explicit
``jax.random`` keys; torch keeps its random state in generators. An
:class:`RngState` holds named ``torch.Generator`` s, by default the
process's global ones: the CPU generator and the default generator of each
CUDA device once CUDA is initialized. Each generator's state is a CPU uint8
tensor (``get_state``/``set_state``), which checkpoints as a dense array.

``Snapshot.take`` saves at most one :class:`RngState` first and
``Snapshot.restore`` restores it last, so that neither taking a snapshot
nor restoring other statefuls leaves a trace in the restored RNG state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


class RngState:
    """Stateful holding ``torch.Generator`` s by name. With no argument it
    holds the process's global generators: ``"cpu"`` and, once CUDA is
    initialized, ``"cuda:<i>"`` for every device."""

    def __init__(self, generators: Optional[Dict[str, torch.Generator]] = None) -> None:
        self.generators = generators

    def state_dict(self) -> Dict[str, Any]:
        if self.generators is not None:
            return {name: g.get_state() for name, g in self.generators.items()}
        states = {"cpu": torch.get_rng_state()}
        # Never initialize CUDA just to checkpoint it: a context that does
        # not exist yet has drawn nothing.
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                states[f"cuda:{i}"] = torch.cuda.get_rng_state(i)
        return states

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        for name, state in state_dict.items():
            if self.generators is not None:
                if name not in self.generators:
                    raise KeyError(f"snapshot holds RNG state {name!r}; this RngState has {sorted(self.generators)}")
                self.generators[name].set_state(state)
            elif name == "cpu":
                torch.set_rng_state(state)
            elif name.startswith("cuda:"):
                torch.cuda.set_rng_state(state, int(name[len("cuda:"):]))
            else:
                raise KeyError(f"snapshot holds RNG state {name!r}, not a global generator")


# Alias matching the reference class name.
RNGState = RngState
