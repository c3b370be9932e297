"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``. On a host without CUDA it raises rather than silently
running on the CPU: a CPU run is asked for with ``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device):
    """Wait for the card (a no-op on the CPU): host-clock timings of work
    on ``device`` end here."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
