"""``TorchStateful``: the JAX package's torch bridge class, native here.

Counterpart of ``torchsnapshot_tpu/tricks/torch.py``. The JAX package
exposes torch state to its snapshot pipeline as numpy views; this package
checkpoints torch tensors directly, so the class needs no conversion. It
keeps the bridge's contract, so that code written against it works by
changing the import:

- a module, optimizer or anything else with ``state_dict()`` /
  ``load_state_dict()`` restores through exactly one ``load_state_dict``;
- a plain state dict is updated in place, non-tensor leaves (step
  counters, learning rates) included, so a caller holding the dict sees
  them; its tensors are restored in place;
- keys present only in the destination survive a restore from a snapshot
  taken before they existed.

Usage::

    from torchsnapshot_tpu_torch.tricks.torch import TorchStateful

    app_state = {"model": TorchStateful(model), "optim": TorchStateful(optim)}
    Snapshot.take(path, app_state)
    ...
    Snapshot(path).restore(app_state)   # tensors restored in place

Snapshots written this way are the native format: the JAX package
restores them too, into numpy arrays or through its own
``TorchStateful``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def _load_into(dst: Any, src: Any, mutate: bool = True) -> Any:
    """Merge restored values back into the original structure. With
    ``mutate`` the tensors are ``copy_``-ed in place (plain-dict statefuls,
    where nothing else will apply the values); without it the restored
    tensors are returned, shaped and typed as the destination's, and the
    single copy is left to ``load_state_dict``."""
    if isinstance(dst, torch.Tensor):
        if src is dst:
            return dst
        t = torch.as_tensor(src).to(device=dst.device, dtype=dst.dtype).reshape(dst.shape)
        if not mutate:
            return t
        with torch.no_grad():
            dst.copy_(t)
        return dst
    if isinstance(dst, dict) and isinstance(src, dict):
        # Destination-only keys are preserved: a snapshot taken before a
        # field existed must not silently erase the field on restore.
        merged_dict = {
            k: _load_into(dst[k], src[k], mutate) if k in dst else src[k]
            for k in src
        }
        if mutate:
            # A caller holding the original dict must see restored
            # non-tensor leaves (step counters, lr floats) too: update
            # the destination in place instead of returning a new dict.
            dst.update(merged_dict)
            return dst
        for k in dst:
            if k not in src:
                merged_dict[k] = dst[k]
        return merged_dict
    if isinstance(dst, (list, tuple)) and isinstance(src, (list, tuple)):
        merged = [_load_into(d, s, mutate) for d, s in zip(dst, src)]
        merged += list(src[len(dst):]) if len(src) > len(dst) else list(dst[len(src):])
        if mutate and isinstance(dst, list):
            dst[: len(merged)] = merged
            return dst
        return merged if isinstance(dst, list) else tuple(merged)
    return src


class TorchStateful:
    """Adapt anything with ``state_dict()/load_state_dict()`` (module,
    optimizer, lr scheduler), or a plain state dict, to the ``Stateful``
    protocol."""

    def __init__(self, obj: Any) -> None:
        self.obj = obj
        self._has_protocol = hasattr(obj, "state_dict") and hasattr(obj, "load_state_dict")

    def _current(self) -> Dict[str, Any]:
        return self.obj.state_dict() if self._has_protocol else self.obj

    def state_dict(self) -> Dict[str, Any]:
        return self._current()

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        if self._has_protocol:
            # load_state_dict performs the one copy into live tensors;
            # _load_into only shapes and types the restored values.
            self.obj.load_state_dict(_load_into(self._current(), state_dict, mutate=False))
        else:
            self.obj = _load_into(self._current(), state_dict, mutate=True)
