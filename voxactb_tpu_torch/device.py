"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` unless the caller names a device; raise when CUDA is absent.

    The port never falls back to the CPU on its own: a run that asked for the
    card and silently ran on the host would report host numbers as device ones.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "voxactb_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return torch.device("cuda")
