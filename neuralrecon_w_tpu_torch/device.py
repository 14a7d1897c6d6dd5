"""Where the port's entry points put their tensors."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` when the caller names one, else the card. There is no
    CPU fallback: on a machine without a card the first allocation on it
    raises, as torch does. The tests pass ``"cpu"``."""
    return torch.device("cuda") if device is None else torch.device(device)
