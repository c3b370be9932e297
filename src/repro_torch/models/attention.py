"""Attention: GQA (covers MHA) with optional biases and qk-norm,
sliding window, logit softcap, cross-attention (enc-dec) and MLA, with
ring-buffer caches (port of ``repro.models.attention``).

Two execution paths for the softmax-attention core of a full sequence:
  * ``impl="xla"``    — plain masked matmul + softmax, written out: scores
    are f32 even for bf16 q and k (the reference's
    ``preferred_element_type=jnp.float32``), masked entries are
    ``NEG_INF``, q is processed in chunks of ``Q_CHUNK`` rows
  * ``impl="kernel"`` — K6 flash attention (``kernels/flash_attention``),
    the counterpart of the reference's ``impl="pallas"``: the GQA prefill
    hot path. The window is a Python int per layer.
Decode, cross-attention and MLA always take the plain path, as in the
reference (MLA's q/k head dim, 96, differs from its v head dim, 64).

KV caches are ring buffers carrying their own position array. The port
writes them in place (``cache_write``), where the reference returns new
arrays: a decode step then copies no cache. A write of more positions
than the ring holds keeps each row's last ``T`` (the reference's CPU
scatter keeps the last of colliding writes; CUDA's does not promise
which).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import (apply_rope, dense_init, rms_norm,
                                       softcap)

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
    D, H, Hkv, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    p = {
        "wq": dense_init(gen, (D, H * Dh)),
        "wk": dense_init(gen, (D, Hkv * Dh)),
        "wv": dense_init(gen, (D, Hkv * Dh)),
        "wo": dense_init(gen, (H * Dh, D)),
    }

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=gen.device)

    if cfg.use_bias:
        p["bq"], p["bk"] = zeros(H * Dh), zeros(Hkv * Dh)
        p["bv"], p["bo"] = zeros(Hkv * Dh), zeros(D)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = zeros(Dh), zeros(Dh)
    return p


def gqa_project_qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Biases before the head reshape; qk-norm over the head dim after it
    and before RoPE, as the reference."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q, k, v = (q + p["bq"].to(dt), k + p["bk"].to(dt),
                   v + p["bv"].to(dt))
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_out(p: dict, out: torch.Tensor) -> torch.Tensor:
    B, S = out.shape[:2]
    y = out.reshape(B, S, -1) @ p["wo"].to(out.dtype)
    if "bo" in p:
        y = y + p["bo"].to(out.dtype)
    return y


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


def _ring_write(cache: dict, positions: torch.Tensor, new: dict) -> dict:
    """Write each (B,S_new,...) tensor of ``new`` into its cache leaf at
    ring slots pos % T, and the positions, in place. Of a write longer
    than the ring only each row's last T positions: more would hit some
    slots twice. Returns ``cache``."""
    T = cache["pos"].shape[1]
    if positions.shape[1] > T:
        positions = positions[:, -T:]
        new = {key: value[:, -T:] for key, value in new.items()}
    slots = (positions % T).long()                               # (B,S)
    b_idx = torch.arange(positions.shape[0],
                         device=positions.device)[:, None]
    for key, value in new.items():
        cache[key][b_idx, slots] = value
    cache["pos"][b_idx, slots] = positions.to(torch.int32)
    return cache


def cache_write(cache: dict, k_new, v_new, positions) -> dict:
    """Write S_new keys and values at ring slots pos % T, in place (of a
    write longer than the ring, each row's last T). positions: (B,S_new).
    Returns ``cache``."""
    return _ring_write(cache, positions, {"k": k_new, "v": v_new})


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


# --- cross-attention (enc-dec) ---------------------------------------------
def cross_attention(p: dict, cfg, x: torch.Tensor, enc_k: torch.Tensor,
                    enc_v: torch.Tensor, enc_valid: torch.Tensor):
    """x: (B,Sq,D) decoder side; enc_k/enc_v: (B,Se,Hkv,Dh). No RoPE, no
    mask but ``enc_valid``."""
    B, Sq, _ = x.shape
    Se = enc_k.shape[1]
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, Sq, H, Dh)
    if "bq" in p:
        q = q + p["bq"].to(dt).reshape(H, Dh)
    zeros_q = torch.zeros((B, Sq), dtype=torch.int32, device=x.device)
    zeros_k = torch.zeros((B, Se), dtype=torch.int32, device=x.device)
    out = attend_masked(q, enc_k, enc_v, q_pos=zeros_q, k_pos=zeros_k,
                        k_valid=enc_valid, causal=False, window=0,
                        scale=Dh ** -0.5)
    return gqa_out(p, out)


def cross_kv(p: dict, cfg, enc_out: torch.Tensor):
    B, Se, _ = enc_out.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = enc_out.dtype
    k = (enc_out @ p["wk"].to(dt)).reshape(B, Se, Hkv, Dh)
    v = (enc_out @ p["wv"].to(dt)).reshape(B, Se, Hkv, Dh)
    if "bk" in p:
        k = k + p["bk"].to(dt).reshape(Hkv, Dh)
        v = v + p["bv"].to(dt).reshape(Hkv, Dh)
    return k, v


# --- MLA: multi-head latent attention (MiniCPM3 / DeepSeek-V2) -------------
def mla_init(gen: torch.Generator, cfg) -> dict:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=gen.device)

    return {
        "w_dq": dense_init(gen, (D, m.q_lora_rank)),
        "q_norm": zeros(m.q_lora_rank),
        "w_uq": dense_init(gen, (m.q_lora_rank,
                                 H * (m.qk_nope_dim + m.qk_rope_dim))),
        # the kv down-projection also emits the shared rotary key
        "w_dkv": dense_init(gen, (D, m.kv_lora_rank + m.qk_rope_dim)),
        "kv_norm": zeros(m.kv_lora_rank),
        "w_uk": dense_init(gen, (m.kv_lora_rank, H * m.qk_nope_dim)),
        "w_uv": dense_init(gen, (m.kv_lora_rank, H * m.v_head_dim)),
        "wo": dense_init(gen, (H * m.v_head_dim, D)),
    }


def _mla_queries(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    dt = x.dtype
    q_lat = rms_norm(x @ p["w_dq"].to(dt), p["q_norm"], cfg.norm_eps)
    q = (q_lat @ p["w_uq"].to(dt)).reshape(
        B, S, H, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latents(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    m = cfg.mla
    dkv = x @ p["w_dkv"].to(x.dtype)
    c_kv = rms_norm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    # the shared single-head rotary key
    k_rope = apply_rope(dkv[:, :, None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_self_attention(p: dict, cfg, x: torch.Tensor,
                       positions: torch.Tensor, *, causal: bool = True):
    """Train/prefill path: the latents expanded to per-head K/V (the
    standard form), plain attention."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    dt = x.dtype
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)
    c_kv, k_rope = _mla_latents(p, cfg, x, positions)
    k_nope = (c_kv @ p["w_uk"].to(dt)).reshape(B, S, H, m.qk_nope_dim)
    v = (c_kv @ p["w_uv"].to(dt)).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_dim)], dim=-1)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    out = attend_masked(q, k, v, q_pos=positions, k_pos=positions,
                        k_valid=torch.ones(positions.shape, dtype=torch.bool,
                                           device=x.device),
                        causal=causal, window=0, scale=scale)
    return out.reshape(B, S, H * m.v_head_dim) @ p["wo"].to(dt)


def mla_cache_init(cfg, batch: int, cache_len: int, dtype, device) -> dict:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, cache_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, cache_len, m.qk_rope_dim),
                              dtype=dtype, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def mla_prefill(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                cache_len: int):
    out = mla_self_attention(p, cfg, x, positions)
    c_kv, k_rope = _mla_latents(p, cfg, x, positions)
    cache = mla_cache_init(cfg, x.shape[0], cache_len, c_kv.dtype, x.device)
    return out, _ring_write(cache, positions,
                            {"c_kv": c_kv, "k_rope": k_rope})


def mla_decode(p: dict, cfg, x: torch.Tensor, cache: dict,
               positions: torch.Tensor):
    """Absorbed decode: attention runs in the compressed latent space.

    The cache holds only (kv_lora + rope) values a position, and W_uk /
    W_uv are absorbed into the query and output projections. Writes the
    new latents into ``cache`` in place."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape                       # S == 1
    dt = x.dtype
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)
    c_new, kr_new = _mla_latents(p, cfg, x, positions)
    cache = _ring_write(cache, positions, {"c_kv": c_new, "k_rope": kr_new})
    w_uk = p["w_uk"].to(dt).reshape(m.kv_lora_rank, H, m.qk_nope_dim)
    q_lat = torch.einsum("bshd,chd->bshc", q_nope, w_uk)      # (B,1,H,C)
    f32 = torch.float32
    scores = (torch.einsum("bshc,btc->bhst", q_lat.to(f32),
                           cache["c_kv"].to(f32))
              + torch.einsum("bshd,btd->bhst", q_rope.to(f32),
                             cache["k_rope"].to(f32)))
    scores = scores * ((m.qk_nope_dim + m.qk_rope_dim) ** -0.5)
    mask = (cache["pos"] >= 0) & (cache["pos"] <= positions[:, :1])
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)              # (B,H,1,T)
    out_lat = torch.einsum("bhst,btc->bshc", probs, cache["c_kv"])
    w_uv = p["w_uv"].to(dt).reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bshc,chd->bshd", out_lat, w_uv)
    return out.reshape(B, S, H * m.v_head_dim) @ p["wo"].to(dt), cache
