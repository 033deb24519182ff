"""Where the port's entry points run.

Every entry point takes ``device=None`` and runs on ``cuda`` unless the
caller names a device; with no CUDA device and no ``device`` argument it
raises rather than fall back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``, and raises
    when there is no CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
