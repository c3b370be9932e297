"""Shared neural-net building blocks (port of ``repro.models.layers``).

Params are plain nested dicts of tensors, stored fp32 (master) and cast at
use site by the model wrapper. Initializers draw from an explicit
``torch.Generator`` on the target device: the same distributions as the
reference's ``jax.random`` draws, not the same numbers.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
import torch.nn.functional as F


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               scale: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal ([-2, 2]) fan-in init for all projections."""
    std = scale / (shape[in_axis] ** 0.5)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in f32, scaled by ``(1 + weight)``."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].to(torch.float32) * inv         # (..., S, D/2)
    sin = torch.sin(ang)[..., None, :]                         # (..., S, 1, D/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             use_bias: bool = False) -> dict:
    """SwiGLU weights, and zero biases when ``use_bias``."""
    p = {
        "w_gate": dense_init(gen, (d_model, d_ff)),
        "w_up": dense_init(gen, (d_model, d_ff)),
        "w_down": dense_init(gen, (d_ff, d_model)),
    }
    if use_bias:
        dev = gen.device
        p["b_gate"] = torch.zeros(d_ff, dtype=torch.float32, device=dev)
        p["b_up"] = torch.zeros(d_ff, dtype=torch.float32, device=dev)
        p["b_down"] = torch.zeros(d_model, dtype=torch.float32, device=dev)
    return p


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    gate = x @ p["w_gate"].to(dtype)
    up = x @ p["w_up"].to(dtype)
    if "b_gate" in p:
        gate = gate + p["b_gate"].to(dtype)
        up = up + p["b_up"].to(dtype)
    out = (F.silu(gate) * up) @ p["w_down"].to(dtype)
    if "b_down" in p:
        out = out + p["b_down"].to(dtype)
    return out


def _gold_logits(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``logits[..., y]``. Over ranks (a DTensor whose vocab dim may be
    sharded) it is the masked sum over the vocab, so each rank sums its
    own columns and only the (B, S) partials are all-reduced, as the
    reference's vocab-parallel CE; the other terms are exact zeros."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, y[..., None])[..., 0]
    ids = torch.arange(logits.shape[-1], device=y.device)
    hit = ids == y[..., None]
    return torch.sum(torch.where(hit, logits, 0.0), dim=-1)


def chunked_softmax_xent(hidden: torch.Tensor, unembed: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor, *,
                         chunk: int = 512,
                         final_softcap: float = 0.0) -> torch.Tensor:
    """Mean next-token CE. hidden: (B,S,D); unembed: (D,V); labels: (B,S).

    Logits are computed chunk by chunk over the sequence, so the peak
    logits buffer is (B, chunk, V). The logsumexp runs over all
    ``unembed`` columns, padded vocab ids included, as the reference's.
    """
    S = hidden.shape[1]
    chunk = min(chunk, S)
    w = unembed.to(hidden.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        h = hidden[:, s0:s0 + chunk]
        y = labels[:, s0:s0 + chunk]
        m = mask[:, s0:s0 + chunk]
        logits = softcap((h @ w).to(torch.float32), final_softcap)
        logz = torch.logsumexp(logits, dim=-1)
        gold = _gold_logits(logits, y)
        tot = tot + torch.sum((logz - gold) * m)
        cnt = cnt + torch.sum(m)
    return tot / torch.clamp(cnt, min=1.0)
