"""Plain PyTorch version of flash attention (port of
``repro.kernels.flash_attention.ref``): masked softmax with f32 scores
and f32 probabilities, the output cast to q's dtype."""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool, window: int,
                  softcap: float) -> torch.Tensor:
    """q: (B,H,Sq,D); k/v: (B,Hkv,Sk,D). Returns (B,H,Sq,D).

    Query i and key j are masked out where ``causal`` and j > i, or where
    ``window`` > 0 and j <= i - window (positions are the indices)."""
    H, Sq = q.shape[1], q.shape[2]
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    kr = torch.repeat_interleave(k, G, dim=1).to(torch.float32)
    vr = torch.repeat_interleave(v, G, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kr) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)
