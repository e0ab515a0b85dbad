"""Where an entry point runs: the caller's device, else the CUDA card."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``device`` given: that device.  ``None``: the CUDA card.  With no card
    visible and none asked for this raises, so the port never drops to the
    CPU quietly; the CPU tests pass ``device="cpu"``.

    Raises:
        RuntimeError: ``device`` is None and no CUDA device is visible.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
