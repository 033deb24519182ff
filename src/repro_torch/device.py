"""Where the port's entry points run.

Every entry point takes ``device=None`` and runs on ``cuda`` unless the
caller names a device; with no CUDA device and no ``device`` argument it
raises rather than fall back to the CPU. A CUDA device without an index
(``None``, ``"cuda"``) is the caller's current card, named by its index,
so that what an entry point reports names the card that computed it; a
named card (``"cuda:1"``) is used as it is, whatever card is current.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA one with its card's index;
    None means the current card, and raises when there is no CUDA
    device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
