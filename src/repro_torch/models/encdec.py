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
from repro_torch.models.layers import (checkpointed, mlp_apply, mlp_init,
                                       rms_norm)
from repro_torch.sharding.serve import batch_only
from repro_torch.sharding.specs import cache_full, placed_layers


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


def _enc_block(cfg, lp: dict, x, positions, impl: str, serve: bool):
    h = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
    x = x + attn.gqa_self_attention(lp["attn"], cfg, h, positions,
                                    window=0, causal=False, impl=impl,
                                    serve=serve)
    h = rms_norm(x, lp["norm_mlp"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], batch_only(h) if serve else h)


def encoder_apply(cfg, stacked: dict, x: torch.Tensor,
                  positions: torch.Tensor, *, impl: str = "xla",
                  remat: bool = True, serve: bool = False):
    """With ``remat`` (and autograd recording) each layer is
    checkpointed, as the reference's scan body. ``serve``: a serve
    program's encoder, head-parallel over ranks (``sharding/serve.py``)."""
    for lp in placed_layers(stacked):
        def body(x_, lp=lp):
            return _enc_block(cfg, lp, x_, positions, impl, serve)
        x = checkpointed(body, x) if remat else body(x)
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


def _dec_block(cfg, lp: dict, x, positions, enc_out, enc_valid, impl: str):
    h = rms_norm(x, lp["norm_self"], cfg.norm_eps)
    x = x + attn.gqa_self_attention(lp["self"], cfg, h, positions,
                                    window=0, causal=True, impl=impl)
    h = rms_norm(x, lp["norm_cross"], cfg.norm_eps)
    ek, ev = attn.cross_kv(lp["cross"], cfg, enc_out)
    x = x + attn.cross_attention(lp["cross"], cfg, h, ek, ev, enc_valid)
    h = rms_norm(x, lp["norm_mlp"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h)


def decoder_apply(cfg, stacked: dict, x: torch.Tensor,
                  positions: torch.Tensor, enc_out: torch.Tensor,
                  enc_valid: torch.Tensor, *, impl: str = "xla",
                  remat: bool = True):
    """Teacher-forced full-sequence decoder pass; with ``remat`` each
    layer is checkpointed, as the reference's scan body."""
    for lp in placed_layers(stacked):
        def body(x_, lp=lp):
            return _dec_block(cfg, lp, x_, positions, enc_out, enc_valid,
                              impl)
        x = checkpointed(body, x) if remat else body(x)
    return x


def decoder_cache_init(cfg, batch: int, cache_len: int, enc_len: int,
                       dtype, device) -> dict:
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    kw = dict(dtype=dtype, device=device, batch=batch)
    return {
        "self": attn.gqa_cache_init(cfg, batch, cache_len, dtype, device),
        "cross_k": cache_full((batch, enc_len, Hkv, Dh), 0, **kw),
        "cross_v": cache_full((batch, enc_len, Hkv, Dh), 0, **kw),
    }


def decoder_fill_cross(cfg, stacked: dict, caches: dict,
                       enc_out: torch.Tensor) -> dict:
    """Fill each layer's cross K/V from the encoder output, in place."""
    for i in range(_n_layers(stacked)):
        ek, ev = attn.cross_kv(_tree.index(stacked, i)["cross"], cfg, enc_out)
        caches["cross_k"] = attn.put(caches["cross_k"], i, ek)
        caches["cross_v"] = attn.put(caches["cross_v"], i, ev)
    return caches


def decoder_decode(cfg, stacked: dict, x: torch.Tensor, caches: dict,
                   positions: torch.Tensor, enc_valid: torch.Tensor):
    """One-token decode through the stacked decoder layers; the self
    caches are updated in place. Over ranks each normed input is whole
    over "model" (``serve.batch_only``), as a serve program's."""
    for i in range(_n_layers(stacked)):
        lp = _tree.index(stacked, i)
        cache, orig = attn.layer_views(caches, i)
        h = batch_only(rms_norm(x, lp["norm_self"], cfg.norm_eps))
        y, _ = attn.gqa_decode(lp["self"], cfg, h, cache["self"], positions,
                               window=0)
        attn.put_back(caches, i, cache, orig)
        x = x + y
        h = batch_only(rms_norm(x, lp["norm_cross"], cfg.norm_eps))
        x = x + attn.cross_attention(lp["cross"], cfg, h, cache["cross_k"],
                                     cache["cross_v"], enc_valid)
        h = batch_only(rms_norm(x, lp["norm_mlp"], cfg.norm_eps))
        x = x + mlp_apply(lp["mlp"], h)
    return x, caches
