"""Decoder stack over stacked layer params (port of
``repro.models.transformer``, ``BLOCK_ATTN`` only).

Per-layer parameters are stacked on a leading (n_layers,) axis exactly as
the reference builds them (the packed layout depends on it). The
reference's ``lax.scan`` over layers becomes a Python loop that indexes
the stacked leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.configs.base import ATTN_GQA, BLOCK_ATTN
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp_apply, mlp_init, rms_norm


def _check_supported(cfg):
    if cfg.block_kind != BLOCK_ATTN or cfg.attn_kind != ATTN_GQA:
        raise NotImplementedError(
            f"block kind {cfg.block_kind!r} / attention {cfg.attn_kind!r}: "
            "only the dense GQA attention block is ported; MoE, SSM, hybrid "
            "and MLA blocks come with ROADMAP queue A item 13")
    if cfg.d_ff <= 0:
        raise NotImplementedError("attention-only blocks are not ported")


def layer_windows(cfg) -> np.ndarray:
    """(L,) int32: sliding window per layer; 0 = global attention."""
    return np.array(
        [cfg.sliding_window if cfg.layer_is_local(i) else 0
         for i in range(cfg.n_layers)], np.int32)


def block_init(gen: torch.Generator, cfg) -> dict:
    _check_supported(cfg)
    dev = gen.device
    return {
        "norm_attn": torch.zeros(cfg.d_model, dtype=torch.float32,
                                 device=dev),
        "attn": attn.gqa_init(gen, cfg),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff),
        "norm_mlp": torch.zeros(cfg.d_model, dtype=torch.float32,
                                device=dev),
    }


def block_apply(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                window: int):
    """Full-sequence block. Returns (x, aux_loss)."""
    _check_supported(cfg)
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    x = x + attn.gqa_self_attention(p["attn"], cfg, h, positions,
                                    window=window)
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    x = x + mlp_apply(p["mlp"], h)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def stack_init(gen: torch.Generator, cfg, n_layers: int) -> dict:
    layers = [block_init(gen, cfg) for _ in range(n_layers)]
    return _tree.tree_map(lambda *xs: torch.stack(xs), *layers)


def stack_apply(cfg, stacked: dict, x: torch.Tensor,
                positions: torch.Tensor, windows):
    """windows: (L,) ints. Returns (x, total_aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, w in enumerate(np.asarray(windows).tolist()):
        lp = _tree.tree_map(lambda a: a[i], stacked)
        x, a = block_apply(cfg, lp, x, positions, int(w))
        aux = aux + a
    return x, aux
