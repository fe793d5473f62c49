"""The device rule of the port: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is visible); anything else
    is taken as given.  The port never drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
