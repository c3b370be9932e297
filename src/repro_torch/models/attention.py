"""GQA self-attention, ``impl="xla"`` path (port of ``repro.models.attention``).

Plain matmul + softmax, written out: scores are f32 even for bf16 q and
k (the reference's ``preferred_element_type=jnp.float32``), masked
entries are ``NEG_INF``, and q is processed in chunks of ``Q_CHUNK``
rows. The flash-attention kernel (K6) comes later, with an ``impl``
switch like the reference's (ROADMAP queue A item 13).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, dense_init, softcap

NEG_INF = -2.3819763e38  # most-negative bf16-representable
Q_CHUNK = 512


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,D), k: (B,Sk,Hkv,D) -> f32 scores (B,Hkv,G,Sq,Sk).

    Inputs are widened to f32 first: the products of bf16 values are
    exact in f32, so this is the reference's bf16 x bf16 -> f32 einsum.
    """
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D).to(torch.float32)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))


def make_attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        k_valid: torch.Tensor, *, causal: bool,
                        window: int) -> torch.Tensor:
    """Boolean mask (B,1,1,Sq,Sk). ``window`` <= 0 means global; a
    windowed layer attends to k_pos in (q_pos - window, q_pos]."""
    qp = q_pos[:, :, None]
    kp = k_pos[:, None, :]
    m = k_valid[:, None, :]
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    return m[:, None, None, :, :]


def _attend_block(q, k, v, mask, *, logit_softcap: float, scale: float):
    """One q-block of masked softmax attention (scores materialized)."""
    B, Sq, H, _ = q.shape
    Dv = v.shape[-1]
    scores = _grouped_scores(q, k) * scale            # (B,Hkv,G,Sq,Sk) f32
    scores = softcap(scores, logit_softcap)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, Dv)


def attend_masked(q, k, v, *, q_pos, k_pos, k_valid, causal: bool,
                  window: int, logit_softcap: float = 0.0, scale: float,
                  q_chunk: int = Q_CHUNK):
    """Masked attention in q-chunks: the peak scores buffer is
    (B, H, q_chunk, Sk). A sequence that is not a whole number of chunks
    runs as one block, as in the reference."""
    Sq = q.shape[1]

    def block(q_blk, qp_blk):
        mask = make_attention_mask(qp_blk, k_pos, k_valid, causal=causal,
                                   window=window)
        return _attend_block(q_blk, k, v, mask,
                             logit_softcap=logit_softcap, scale=scale)

    if Sq <= q_chunk or Sq % q_chunk != 0:
        return block(q, q_pos)
    return torch.cat([block(q[:, s:s + q_chunk], q_pos[:, s:s + q_chunk])
                      for s in range(0, Sq, q_chunk)], dim=1)


def gqa_init(gen: torch.Generator, cfg) -> dict:
    if cfg.use_bias or cfg.qk_norm:
        raise NotImplementedError(
            "attention biases and qk_norm are not ported yet "
            "(ROADMAP queue A item 13)")
    D, H, Hkv, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    return {
        "wq": dense_init(gen, (D, H * Dh)),
        "wk": dense_init(gen, (D, Hkv * Dh)),
        "wv": dense_init(gen, (D, Hkv * Dh)),
        "wo": dense_init(gen, (H * Dh, D)),
    }


def gqa_project_qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, Dh)
    k = (x @ p["wk"].to(dt)).reshape(B, S, Hkv, Dh)
    v = (x @ p["wv"].to(dt)).reshape(B, S, Hkv, Dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_out(p: dict, out: torch.Tensor) -> torch.Tensor:
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ p["wo"].to(out.dtype)


def gqa_self_attention(p: dict, cfg, x: torch.Tensor,
                       positions: torch.Tensor, *, window: int,
                       causal: bool = True):
    """Full-sequence self-attention (train), the reference's
    ``impl="xla"`` path."""
    q, k, v = gqa_project_qkv(p, cfg, x, positions)
    out = attend_masked(q, k, v, q_pos=positions, k_pos=positions,
                        k_valid=torch.ones(positions.shape, dtype=torch.bool,
                                           device=positions.device),
                        causal=causal, window=int(window),
                        logit_softcap=cfg.attn_logit_softcap,
                        scale=cfg.resolved_head_dim ** -0.5)
    return gqa_out(p, out)
