"""Where the port's entry points put the tensors they make."""

from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device) -> torch.device:
    """``None`` means the CUDA card; without one that raises unless the
    caller asked for the CPU explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: torchsnapshot_tpu_torch's models run on the card; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
