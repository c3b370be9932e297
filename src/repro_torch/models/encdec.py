"""Encoder-decoder backbone (seamless-m4t's text/speech LM side; port of
``repro.models.encdec``).

Encoder: bidirectional self-attention blocks over the frontend's
embeddings (K6, non-causal, on ``impl="kernel"``). Decoder: causal
self-attention, cross-attention over the encoder output and an MLP. The
reference's ``lax.scan`` over layers becomes a Python loop over the
stacked leaves; decode caches are updated in place.
"""
from __future__ import annotations

import torch

from repro_torch import tree as _tree
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp_apply, mlp_init, rms_norm


def _zeros(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.float32, device=gen.device)


def _n_layers(stacked: dict) -> int:
    return _tree.leaves(stacked)[0].shape[0]


# --- encoder ----------------------------------------------------------------
def enc_block_init(gen: torch.Generator, cfg) -> dict:
    return {
        "norm_attn": _zeros(gen, cfg.d_model),
        "attn": attn.gqa_init(gen, cfg),
        "norm_mlp": _zeros(gen, cfg.d_model),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.use_bias),
    }


def encoder_apply(cfg, stacked: dict, x: torch.Tensor,
                  positions: torch.Tensor, *, impl: str = "xla"):
    for i in range(_n_layers(stacked)):
        lp = _tree.index(stacked, i)
        h = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
        x = x + attn.gqa_self_attention(lp["attn"], cfg, h, positions,
                                        window=0, causal=False, impl=impl)
        h = rms_norm(x, lp["norm_mlp"], cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h)
    return x


# --- decoder ----------------------------------------------------------------
def dec_block_init(gen: torch.Generator, cfg) -> dict:
    return {
        "norm_self": _zeros(gen, cfg.d_model),
        "self": attn.gqa_init(gen, cfg),
        "norm_cross": _zeros(gen, cfg.d_model),
        "cross": attn.gqa_init(gen, cfg),
        "norm_mlp": _zeros(gen, cfg.d_model),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.use_bias),
    }


def decoder_apply(cfg, stacked: dict, x: torch.Tensor,
                  positions: torch.Tensor, enc_out: torch.Tensor,
                  enc_valid: torch.Tensor, *, impl: str = "xla"):
    """Teacher-forced full-sequence decoder pass."""
    for i in range(_n_layers(stacked)):
        lp = _tree.index(stacked, i)
        h = rms_norm(x, lp["norm_self"], cfg.norm_eps)
        x = x + attn.gqa_self_attention(lp["self"], cfg, h, positions,
                                        window=0, causal=True, impl=impl)
        h = rms_norm(x, lp["norm_cross"], cfg.norm_eps)
        ek, ev = attn.cross_kv(lp["cross"], cfg, enc_out)
        x = x + attn.cross_attention(lp["cross"], cfg, h, ek, ev, enc_valid)
        h = rms_norm(x, lp["norm_mlp"], cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h)
    return x


def decoder_cache_init(cfg, batch: int, cache_len: int, enc_len: int,
                       dtype, device) -> dict:
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "self": attn.gqa_cache_init(cfg, batch, cache_len, dtype, device),
        "cross_k": torch.zeros((batch, enc_len, Hkv, Dh), dtype=dtype,
                               device=device),
        "cross_v": torch.zeros((batch, enc_len, Hkv, Dh), dtype=dtype,
                               device=device),
    }


def decoder_fill_cross(cfg, stacked: dict, caches: dict,
                       enc_out: torch.Tensor) -> dict:
    """Fill each layer's cross K/V from the encoder output, in place."""
    for i in range(_n_layers(stacked)):
        ek, ev = attn.cross_kv(_tree.index(stacked, i)["cross"], cfg, enc_out)
        caches["cross_k"][i] = ek
        caches["cross_v"][i] = ev
    return caches


def decoder_decode(cfg, stacked: dict, x: torch.Tensor, caches: dict,
                   positions: torch.Tensor, enc_valid: torch.Tensor):
    """One-token decode through the stacked decoder layers; the self
    caches are updated in place."""
    for i in range(_n_layers(stacked)):
        lp, cache = _tree.index(stacked, i), _tree.index(caches, i)
        h = rms_norm(x, lp["norm_self"], cfg.norm_eps)
        y, _ = attn.gqa_decode(lp["self"], cfg, h, cache["self"], positions,
                               window=0)
        x = x + y
        h = rms_norm(x, lp["norm_cross"], cfg.norm_eps)
        x = x + attn.cross_attention(lp["cross"], cfg, h, cache["cross_k"],
                                     cache["cross_v"], enc_valid)
        h = rms_norm(x, lp["norm_mlp"], cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h)
    return x, caches
