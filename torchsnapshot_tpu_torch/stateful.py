"""The ``Stateful`` protocol: anything that can produce and absorb a state dict.

Counterpart of ``torchsnapshot_tpu/stateful.py``. ``torch.nn.Module`` and
``torch.optim.Optimizer`` satisfy it as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Protocol, runtime_checkable


@runtime_checkable
class Stateful(Protocol):
    def state_dict(self) -> Dict[str, Any]: ...

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None: ...


AppState = Dict[str, Stateful]
