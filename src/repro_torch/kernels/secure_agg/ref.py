"""Plain PyTorch versions of the secure-aggregation combines.

masked_sum(x, w)              = sum_i w_i * x_i
masked_sum_corrected(x, c, w) = sum_i w_i * (x_i - c_i)
secure_agg(q, s, w)           = sum_i (w_i * s_i) * float(q_i)

x, c: (N, T) fp32; q: (N, T) int8; w, s: (N,) fp32 -> (T,) fp32. These
are the definitions the CUDA kernels are tested against, and what the
wrappers run for CPU tensors.
"""
from __future__ import annotations

import torch


def masked_sum_ref(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return torch.tensordot(weights.to(torch.float32), x.to(torch.float32),
                           dims=([0], [0]))


def masked_sum_corrected_ref(x: torch.Tensor, corr: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    return torch.tensordot(weights.to(torch.float32),
                           x.to(torch.float32) - corr.to(torch.float32),
                           dims=([0], [0]))


def secure_agg_ref(q: torch.Tensor, scales: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """``(w*s) @ q.float()``: the per-client scale folds into the weight
    in f32 first, as the kernel's wrapper does."""
    ws = weights.to(torch.float32) * scales.to(torch.float32)
    return torch.tensordot(ws, q.to(torch.float32), dims=([0], [0]))
