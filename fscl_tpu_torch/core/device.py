"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`cuda` unless the caller names another device. Asking for CUDA on a
    machine without it raises: the port never carries on quietly on the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev
