"""GQA self-attention and its ring-buffer KV cache (port of
``repro.models.attention``).

Two execution paths for the softmax-attention core of a full sequence:
  * ``impl="xla"``    — plain masked matmul + softmax, written out: scores
    are f32 even for bf16 q and k (the reference's
    ``preferred_element_type=jnp.float32``), masked entries are
    ``NEG_INF``, q is processed in chunks of ``Q_CHUNK`` rows
  * ``impl="kernel"`` — K6 flash attention (``kernels/flash_attention``),
    the counterpart of the reference's ``impl="pallas"``: the prefill hot
    path. The window is a Python int per layer.
Decode always takes ``attend`` over the cache, as in the reference.

KV caches are ring buffers carrying their own position array. The port
writes them in place (``cache_write``), where the reference returns new
arrays: a decode step then copies no cache.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, dense_init, softcap

NEG_INF = -2.3819763e38  # most-negative bf16-representable
Q_CHUNK = 512
IMPLS = ("xla", "kernel")


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


def attend(q, k, v, mask, *, logit_softcap: float = 0.0, scale: float):
    """Single-block path (decode, small sequences, tests)."""
    return _attend_block(q, k, v, mask, logit_softcap=logit_softcap,
                         scale=scale)


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


def _self_attend(cfg, q, k, v, positions, *, window: int, causal: bool,
                 impl: str):
    """The attention core over a full sequence, by ``impl``.

    ``"kernel"`` masks causal and window by index, so it assumes
    ``positions`` is ``arange(S)`` in every row, as the model's stream
    gives; ``"xla"`` masks by ``positions`` themselves. Offset or packed
    positions need the ``"xla"`` path."""
    scale = cfg.resolved_head_dim ** -0.5
    if impl == "kernel":
        return flash_ops.flash_attention(
            q, k, v, causal=causal, window=int(window),
            logit_softcap=cfg.attn_logit_softcap, scale=scale)
    if impl != "xla":
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return attend_masked(q, k, v, q_pos=positions, k_pos=positions,
                         k_valid=torch.ones(positions.shape, dtype=torch.bool,
                                            device=positions.device),
                         causal=causal, window=int(window),
                         logit_softcap=cfg.attn_logit_softcap, scale=scale)


def gqa_self_attention(p: dict, cfg, x: torch.Tensor,
                       positions: torch.Tensor, *, window: int,
                       causal: bool = True, impl: str = "xla"):
    """Full-sequence self-attention (train / prefill)."""
    q, k, v = gqa_project_qkv(p, cfg, x, positions)
    out = _self_attend(cfg, q, k, v, positions, window=window, causal=causal,
                       impl=impl)
    return gqa_out(p, out)


def gqa_prefill(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                window: int, cache_len: int, impl: str = "xla"):
    """Full-sequence self-attention that also fills a fresh KV cache."""
    q, k, v = gqa_project_qkv(p, cfg, x, positions)
    out = _self_attend(cfg, q, k, v, positions, window=window, causal=True,
                       impl=impl)
    cache = gqa_cache_init(cfg, x.shape[0], cache_len, k.dtype, x.device)
    cache = cache_write(cache, k, v, positions)
    return gqa_out(p, out), cache


# --- decode with ring-buffer cache ----------------------------------------
def gqa_cache_init(cfg, batch: int, cache_len: int, dtype,
                   device) -> dict:
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, cache_len, Hkv, Dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, Hkv, Dh), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def cache_write(cache: dict, k_new, v_new, positions) -> dict:
    """Write S_new entries at ring slots pos % T, in place. positions:
    (B,S_new). Returns ``cache``."""
    T = cache["k"].shape[1]
    slots = (positions % T).long()                               # (B,S)
    b_idx = torch.arange(k_new.shape[0], device=k_new.device)[:, None]
    cache["k"][b_idx, slots] = k_new
    cache["v"][b_idx, slots] = v_new
    cache["pos"][b_idx, slots] = positions.to(torch.int32)
    return cache


def gqa_decode(p: dict, cfg, x: torch.Tensor, cache: dict,
               positions: torch.Tensor, *, window: int):
    """x: (B,1,D); positions: (B,1) absolute position of the new token.
    Writes the new key and value into ``cache`` in place."""
    q, k_new, v_new = gqa_project_qkv(p, cfg, x, positions)
    cache = cache_write(cache, k_new, v_new, positions)
    k_valid = cache["pos"] >= 0
    mask = make_attention_mask(positions, cache["pos"], k_valid,
                               causal=True, window=int(window))
    out = attend(q, cache["k"], cache["v"], mask,
                 logit_softcap=cfg.attn_logit_softcap,
                 scale=cfg.resolved_head_dim ** -0.5)
    return gqa_out(p, out), cache
