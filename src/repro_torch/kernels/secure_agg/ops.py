"""Public secure-agg combines: K1 ``masked_sum``, K2
``masked_sum_corrected`` and K5 ``secure_agg_combine``, plus the
pytree-level quantized FedAvg ``combine_pytrees`` built on K5.

For a CPU tensor the wrapper runs the plain version (``ref.py``). For a
CUDA tensor it checks the inputs, allocates the output, launches the
hand-written kernel on the current stream and counts the launch in
``LAUNCHES``; it never falls back and never copies a non-contiguous input
into shape — it raises.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from repro_torch import tree as _tree
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.kernels.secure_agg import kernel as _k
from repro_torch.kernels.secure_agg import ref as _ref

# kernel launches per wrapper since the last reset (plain-version calls on
# CPU tensors do not count)
LAUNCHES: Dict[str, int] = {"masked_sum": 0, "masked_sum_corrected": 0,
                            "secure_agg_combine": 0}


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


def check_secure_agg_combine(q: torch.Tensor, scales: torch.Tensor,
                             weights: torch.Tensor):
    """The checks K5's wrapper runs before a launch."""
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    if q.dim() != 2:
        raise ValueError(f"q must be (N, T), got {tuple(q.shape)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    n = q.shape[0]
    for name, a in (("scales", scales), ("weights", weights)):
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")
        if a.dtype != torch.float32 or tuple(a.shape) != (n,):
            raise ValueError(
                f"{name} must be float32 of shape ({n},), got "
                f"{a.dtype} {tuple(a.shape)}")


def secure_agg_combine(q: torch.Tensor, scales: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Dequantize-and-weight combine of int8 rows with one scale per row:
    (N, T) int8, (N,), (N,) -> (T,) f32."""
    if q.device.type == "cpu":
        return _ref.secure_agg_ref(q, scales, weights)
    check_secure_agg_combine(q, scales, weights)
    ws = (weights * scales).contiguous()      # f32, as kernel.py:63 forms it
    out = torch.empty(q.shape[1], dtype=torch.float32, device=q.device)
    _k.secure_agg_combine_flat(q, ws, out)
    LAUNCHES["secure_agg_combine"] += 1
    return out


def quantize_update(update_flat: torch.Tensor):
    """Symmetric per-tensor int8 quantization: ``(q, scale)`` with scale
    ``max|x|/127 + 1e-12`` in f32 and q rounded half to even, clipped to
    [-127, 127]."""
    scale = update_flat.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(update_flat / scale), -127, 127).to(
        torch.int8)
    return q, scale


def combine_pytrees(updates: Sequence, weights, *,
                    device=DEFAULT_DEVICE):
    """Quantized weighted combine of same-structure parameter trees
    through K5; the result has the first update's structure, f32 leaves
    on ``device``. Leaves flatten in JAX's order (``repro_torch.tree``)."""
    dev = resolve(device)
    flats = [torch.cat([torch.as_tensor(leaf).detach().reshape(-1)
                        .to(dev, torch.float32)
                        for leaf in _tree.leaves(u)]) for u in updates]
    qs, scales = zip(*[quantize_update(f) for f in flats])
    out = secure_agg_combine(torch.stack(qs), torch.stack(scales),
                             torch.as_tensor(weights, dtype=torch.float32)
                             .to(dev))
    leaves, treedef = _tree.flatten(updates[0])
    res, off = [], 0
    for leaf in leaves:
        shape = tuple(leaf.shape)
        n = math.prod(shape)
        res.append(out[off:off + n].reshape(shape))
        off += n
    return _tree.unflatten(treedef, res)
