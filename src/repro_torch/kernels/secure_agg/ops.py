"""Public secure-agg combines: K1 ``masked_sum`` and K2
``masked_sum_corrected``.

For a CPU tensor the wrapper runs the plain version (``ref.py``). For a
CUDA tensor it checks the inputs, allocates the output, launches the
hand-written kernel on the current stream and counts the launch in
``LAUNCHES``; it never falls back and never copies a non-contiguous input
into shape — it raises.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.secure_agg import kernel as _k
from repro_torch.kernels.secure_agg import ref as _ref

# kernel launches per wrapper since the last reset (plain-version calls on
# CPU tensors do not count)
LAUNCHES: Dict[str, int] = {"masked_sum": 0, "masked_sum_corrected": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_rows(name: str, a: torch.Tensor, shape=None):
    if a.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {a.dtype}")
    if a.dim() != 2:
        raise ValueError(f"{name} must be (N, T), got {tuple(a.shape)}")
    if shape is not None and tuple(a.shape) != shape:
        raise ValueError(f"{name} shape {tuple(a.shape)} != {shape}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_cuda(x: torch.Tensor, weights: torch.Tensor, *others):
    for name, a in (("weights", weights), *others):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
    _check_rows("x", x)
    n = x.shape[0]
    if weights.dtype != torch.float32 or tuple(weights.shape) != (n,):
        raise ValueError(
            f"weights must be float32 of shape ({n},), got "
            f"{weights.dtype} {tuple(weights.shape)}")
    if not weights.is_contiguous():
        raise ValueError("weights must be contiguous")


def masked_sum(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum of packed fp32 rows: (N, T), (N,) -> (T,)."""
    if x.device.type == "cpu":
        return _ref.masked_sum_ref(x, weights)
    _check_cuda(x, weights)
    out = torch.empty(x.shape[1], dtype=torch.float32, device=x.device)
    _k.masked_sum_flat(x, weights, out)
    LAUNCHES["masked_sum"] += 1
    return out


def masked_sum_corrected(x: torch.Tensor, corr: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Dropout-repair combine: sum_i w_i * (x_i - corr_i), (T,) fp32."""
    if x.device.type == "cpu":
        return _ref.masked_sum_corrected_ref(x, corr, weights)
    _check_cuda(x, weights, ("corr", corr))
    _check_rows("corr", corr, tuple(x.shape))
    out = torch.empty(x.shape[1], dtype=torch.float32, device=x.device)
    _k.masked_sum_corrected_flat(x, corr, weights, out)
    LAUNCHES["masked_sum_corrected"] += 1
    return out
