"""Device selection for the port's entry points.

The port targets one CUDA card.  Entry points take `device=None`, which
means the card; the CPU is used only when the caller asks for it
(`device="cpu"`, or `-g cpu` on the CLI).  Without a card and without an
explicit CPU request the entry point raises instead of silently running
on the host.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, int, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> cuda; 'cpu' -> cpu; an int or 'N' -> cuda:N; else torch.device.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and torch.cuda.is_available() is false.
    """
    if device is None:
        dev = torch.device("cuda")
    elif isinstance(device, torch.device):
        dev = device
    elif isinstance(device, int) or (isinstance(device, str)
                                     and device.isdigit()):
        dev = torch.device("cuda", int(device))
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' (CLI: -g cpu) to run on the host")
    return dev
