"""Decoder stack over stacked layer params (port of
``repro.models.transformer``: the attention, MoE, SSM and hybrid blocks,
GQA or MLA attention).

Per-layer parameters are stacked on a leading (n_layers,) axis exactly as
the reference builds them (the packed layout depends on it). The
reference's ``lax.scan`` over layers becomes a Python loop that indexes
the stacked leaves, and each layer's window is a Python int. Decode
caches keep the reference's tree (``{"attn": {k, v, pos}}``, MLA's
``{"attn": {c_kv, k_rope, pos}}``, ``{"ssm": {conv, state}}``) with a
leading (L,) axis; ``stack_decode`` updates them in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.configs.base import (ATTN_MLA, BLOCK_ATTN, BLOCK_HYBRID,
                                      BLOCK_MOE, BLOCK_SSM)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import mlp_apply, mlp_init, rms_norm


def _has_attn(cfg) -> bool:
    return cfg.block_kind in (BLOCK_ATTN, BLOCK_MOE, BLOCK_HYBRID)


def _has_ssm(cfg) -> bool:
    return cfg.block_kind in (BLOCK_SSM, BLOCK_HYBRID)


def _is_mla(cfg) -> bool:
    return cfg.attn_kind == ATTN_MLA


def layer_windows(cfg) -> np.ndarray:
    """(L,) int32: sliding window per layer; 0 = global attention."""
    return np.array(
        [cfg.sliding_window if cfg.layer_is_local(i) else 0
         for i in range(cfg.n_layers)], np.int32)


def block_init(gen: torch.Generator, cfg) -> dict:
    dev = gen.device
    p = {"norm_attn": torch.zeros(cfg.d_model, dtype=torch.float32,
                                  device=dev)}
    if _has_attn(cfg):
        p["attn"] = (attn.mla_init(gen, cfg) if _is_mla(cfg)
                     else attn.gqa_init(gen, cfg))
    if _has_ssm(cfg):
        p["ssm"] = ssm_mod.ssm_init(gen, cfg)
    if cfg.block_kind == BLOCK_MOE:
        p["moe"] = moe_mod.moe_init(gen, cfg)
    elif cfg.d_ff > 0:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.use_bias)
    if "moe" in p or "mlp" in p:
        p["norm_mlp"] = torch.zeros(cfg.d_model, dtype=torch.float32,
                                    device=dev)
    return p


def _ffn(cfg, p: dict, x: torch.Tensor):
    """The block's second half: (x, aux_loss of a MoE router or None)."""
    if "moe" in p:
        y, aux = moe_mod.moe_apply(p["moe"], cfg,
                                   rms_norm(x, p["norm_mlp"], cfg.norm_eps))
        return x + y, aux
    if "mlp" in p:
        h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        return x + mlp_apply(p["mlp"], h), None
    return x, None


def block_apply(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                window: int, *, impl: str = "xla"):
    """Full-sequence block. Returns (x, aux_loss)."""
    kind = cfg.block_kind
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    if kind == BLOCK_SSM:
        x = x + ssm_mod.ssm_forward(p["ssm"], cfg, h, impl=impl)
    elif kind == BLOCK_HYBRID:
        a = attn.gqa_self_attention(p["attn"], cfg, h, positions,
                                    window=window, impl=impl)
        s = ssm_mod.ssm_forward(p["ssm"], cfg, h, impl=impl)
        x = x + 0.5 * (a + s)          # Hymba: fused parallel heads
    elif _is_mla(cfg):
        x = x + attn.mla_self_attention(p["attn"], cfg, h, positions)
    else:
        x = x + attn.gqa_self_attention(p["attn"], cfg, h, positions,
                                        window=window, impl=impl)
    x, aux = _ffn(cfg, p, x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def block_cache_init(cfg, batch: int, cache_len: int, dtype,
                     device) -> dict:
    c = {}
    if _has_attn(cfg):
        c["attn"] = (attn.mla_cache_init(cfg, batch, cache_len, dtype, device)
                     if _is_mla(cfg) else
                     attn.gqa_cache_init(cfg, batch, cache_len, dtype, device))
    if _has_ssm(cfg):
        c["ssm"] = ssm_mod.ssm_cache_init(cfg, batch, dtype, device)
    return c


def block_decode(cfg, p: dict, x: torch.Tensor, cache: dict,
                 positions: torch.Tensor, window: int):
    """One-token decode. x: (B,1,D). Returns (x, cache), the cache updated
    in place."""
    kind = cfg.block_kind
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    if kind == BLOCK_SSM:
        y, _ = ssm_mod.ssm_decode(p["ssm"], cfg, h, cache["ssm"])
        x = x + y
    elif kind == BLOCK_HYBRID:
        a, _ = attn.gqa_decode(p["attn"], cfg, h, cache["attn"], positions,
                               window=window)
        s, _ = ssm_mod.ssm_decode(p["ssm"], cfg, h, cache["ssm"])
        x = x + 0.5 * (a + s)
    elif _is_mla(cfg):
        y, _ = attn.mla_decode(p["attn"], cfg, h, cache["attn"], positions)
        x = x + y
    else:
        y, _ = attn.gqa_decode(p["attn"], cfg, h, cache["attn"], positions,
                               window=window)
        x = x + y
    return _ffn(cfg, p, x)[0], cache


def block_prefill(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                  window: int, cache_len: int, *, impl: str = "xla"):
    """Full-sequence pass that also produces this block's decode cache."""
    kind = cfg.block_kind
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    cache = {}
    if kind == BLOCK_SSM:
        y, cache["ssm"] = ssm_mod.ssm_prefill(p["ssm"], cfg, h, impl=impl)
        x = x + y
    elif kind == BLOCK_HYBRID:
        a, cache["attn"] = attn.gqa_prefill(p["attn"], cfg, h, positions,
                                            window=window,
                                            cache_len=cache_len, impl=impl)
        s, cache["ssm"] = ssm_mod.ssm_prefill(p["ssm"], cfg, h, impl=impl)
        x = x + 0.5 * (a + s)
    elif _is_mla(cfg):
        y, cache["attn"] = attn.mla_prefill(p["attn"], cfg, h, positions,
                                            cache_len=cache_len)
        x = x + y
    else:
        y, cache["attn"] = attn.gqa_prefill(p["attn"], cfg, h, positions,
                                            window=window,
                                            cache_len=cache_len, impl=impl)
        x = x + y
    return _ffn(cfg, p, x)[0], cache


def stack_init(gen: torch.Generator, cfg, n_layers: int) -> dict:
    return _tree.stack_trees(lambda: block_init(gen, cfg), n_layers)


def stack_apply(cfg, stacked: dict, x: torch.Tensor,
                positions: torch.Tensor, windows, *, impl: str = "xla"):
    """windows: (L,) ints. Returns (x, total_aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, w in enumerate(np.asarray(windows).tolist()):
        x, a = block_apply(cfg, _tree.index(stacked, i), x, positions,
                           int(w), impl=impl)
        aux = aux + a
    return x, aux


def stack_prefill(cfg, stacked: dict, x: torch.Tensor,
                  positions: torch.Tensor, windows, cache_len: int, *,
                  impl: str = "xla"):
    """Returns (x, stacked caches with leading (L,) axis)."""
    caches = []
    for i, w in enumerate(np.asarray(windows).tolist()):
        x, cache = block_prefill(cfg, _tree.index(stacked, i), x, positions,
                                 int(w), cache_len, impl=impl)
        caches.append(cache)
    return x, _tree.tree_map(lambda *xs: torch.stack(xs), *caches)


def stack_decode(cfg, stacked: dict, x: torch.Tensor, caches: dict,
                 positions: torch.Tensor, windows):
    """caches: tree with leading (L,) axis, updated in place. Returns
    (x, caches)."""
    for i, w in enumerate(np.asarray(windows).tolist()):
        x, _ = block_decode(cfg, _tree.index(stacked, i), x,
                            _tree.index(caches, i), positions, int(w))
    return x, caches


def stack_cache_init(cfg, batch: int, cache_len: int, dtype, n_layers: int,
                     device) -> dict:
    one = block_cache_init(cfg, batch, cache_len, dtype, device)
    return _tree.tree_map(
        lambda a: a[None].expand((n_layers,) + a.shape).clone(), one)
