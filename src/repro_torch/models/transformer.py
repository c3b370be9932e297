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

A ``layer_pattern`` config (``BLOCK_PATTERN``, Nemotron-H's layout) has
one pre-norm mixer a layer, ``x + mixer(RMSNorm(x))``, of three kinds:
Mamba2 (``"M"``), MoE (``"E"``) and GQA attention (``"*"``). Its stack is
``{"mamba", "moe", "attention"}``, each kind's layers stacked on their
own leading axis in pattern order (``layer_slots`` maps layer i to its
kind and index), and its cache ``{"mamba": {conv, state}, "attention":
{k, v, pos}}`` likewise; an MoE layer has none. The other configs keep
the one stack and the code paths they always had.
"""
from __future__ import annotations

import os
import weakref

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.configs.base import (ATTN_MLA, BLOCK_ATTN, BLOCK_HYBRID,
                                      BLOCK_MOE, BLOCK_PATTERN, BLOCK_SSM,
                                      LAYER_ATTN, LAYER_KINDS, LAYER_MOE,
                                      LAYER_SSM)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (checkpointed, mlp_apply, mlp_init,
                                       rms_norm)
from repro_torch.sharding.serve import batch_only
from repro_torch.sharding.specs import P, constrain, placed_layers


def _has_attn(cfg) -> bool:
    return cfg.block_kind in (BLOCK_ATTN, BLOCK_MOE, BLOCK_HYBRID)


def _has_ssm(cfg) -> bool:
    return cfg.block_kind in (BLOCK_SSM, BLOCK_HYBRID)


def _is_mla(cfg) -> bool:
    return cfg.attn_kind == ATTN_MLA


def _is_pattern(cfg) -> bool:
    return cfg.block_kind == BLOCK_PATTERN


def layer_slots(cfg) -> list:
    """Layer i of a pattern config as (kind name, index in its stack)."""
    seen: dict = {}
    slots = []
    for k in cfg.layer_kinds():
        name = LAYER_KINDS[k]
        slots.append((name, seen.get(name, 0)))
        seen[name] = seen.get(name, 0) + 1
    return slots


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


def _ffn(cfg, p: dict, x: torch.Tensor, *, serve: bool = False):
    """The block's second half: (x, aux_loss of a MoE router or None).
    ``serve``: a serve program's, whose normed input is whole over
    "model" over ranks (``serve.batch_only``): the Megatron MLP, one
    reduction of its output."""
    if "moe" in p:
        h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        y, aux = moe_mod.moe_apply(p["moe"], cfg,
                                   batch_only(h) if serve else h)
        return x + y, aux
    if "mlp" in p:
        h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        return x + mlp_apply(p["mlp"], batch_only(h) if serve else h), None
    return x, None


def _seq_shard(x: torch.Tensor) -> torch.Tensor:
    """seqpar variant (``REPRO_SEQ_SHARD=1``): the residual stream
    constrained to (batch: data, seq: model) between blocks, Megatron
    sequence parallelism, on the mesh in scope; the identity otherwise."""
    if os.environ.get("REPRO_SEQ_SHARD") != "1" or x.dim() != 3:
        return x
    return constrain(x, P("data", "model", None))


def block_apply(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                window: int, *, impl: str = "xla"):
    """Full-sequence block. Returns (x, aux_loss)."""
    kind = cfg.block_kind
    x = _seq_shard(x)
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
    return _seq_shard(x), aux


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
    in place. Spans ``serve.attention``, ``serve.ssm``, ``serve.ffn``."""
    # repro_torch.core imports this module: import its telemetry late
    from repro_torch.core.telemetry import current
    kind = cfg.block_kind
    tel, dev = current(), x.device
    h = batch_only(rms_norm(x, p["norm_attn"], cfg.norm_eps))
    if kind == BLOCK_SSM:
        with tel.span("serve.ssm", cat="serve", device=dev):
            y, _ = ssm_mod.ssm_decode(p["ssm"], cfg, h, cache["ssm"])
        x = x + y
    elif kind == BLOCK_HYBRID:
        with tel.span("serve.attention", cat="serve", device=dev):
            a, _ = attn.gqa_decode(p["attn"], cfg, h, cache["attn"],
                                   positions, window=window)
        with tel.span("serve.ssm", cat="serve", device=dev):
            s, _ = ssm_mod.ssm_decode(p["ssm"], cfg, h, cache["ssm"])
        x = x + 0.5 * (a + s)
    else:
        with tel.span("serve.attention", cat="serve", device=dev):
            if _is_mla(cfg):
                y, _ = attn.mla_decode(p["attn"], cfg, h, cache["attn"],
                                       positions)
            else:
                y, _ = attn.gqa_decode(p["attn"], cfg, h, cache["attn"],
                                       positions, window=window)
        x = x + y
    with tel.span("serve.ffn", cat="serve", device=dev):
        return _ffn(cfg, p, x, serve=True)[0], cache


def block_prefill(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                  window: int, cache_len: int, *, impl: str = "xla"):
    """Full-sequence pass that also produces this block's decode cache.
    Over ranks its normed stream is whole over "model" and each layer
    head-parallel (``sharding/serve.py``), as a serve program's. Spans
    ``serve.attention``, ``serve.ssm``, ``serve.ffn``."""
    # repro_torch.core imports this module: import its telemetry late
    from repro_torch.core.telemetry import current
    kind = cfg.block_kind
    tel, dev = current(), x.device
    h = batch_only(rms_norm(x, p["norm_attn"], cfg.norm_eps))
    cache = {}
    if kind == BLOCK_SSM:
        with tel.span("serve.ssm", cat="serve", device=dev):
            y, cache["ssm"] = ssm_mod.ssm_prefill(p["ssm"], cfg, h,
                                                  impl=impl)
        x = x + y
    elif kind == BLOCK_HYBRID:
        with tel.span("serve.attention", cat="serve", device=dev):
            a, cache["attn"] = attn.gqa_prefill(
                p["attn"], cfg, h, positions, window=window,
                cache_len=cache_len, impl=impl)
        with tel.span("serve.ssm", cat="serve", device=dev):
            s, cache["ssm"] = ssm_mod.ssm_prefill(p["ssm"], cfg, h,
                                                  impl=impl)
        x = x + 0.5 * (a + s)
    else:
        with tel.span("serve.attention", cat="serve", device=dev):
            if _is_mla(cfg):
                y, cache["attn"] = attn.mla_prefill(
                    p["attn"], cfg, h, positions, cache_len=cache_len)
            else:
                y, cache["attn"] = attn.gqa_prefill(
                    p["attn"], cfg, h, positions, window=window,
                    cache_len=cache_len, impl=impl)
        x = x + y
    with tel.span("serve.ffn", cat="serve", device=dev):
        return _ffn(cfg, p, x, serve=True)[0], cache


def _mixer_init(gen: torch.Generator, cfg, kind: str) -> dict:
    """One pattern layer's params: its pre-norm ``norm`` and its mixer's
    leaves, in one dict."""
    p = {"norm": torch.zeros(cfg.d_model, dtype=torch.float32,
                             device=gen.device)}
    if kind == LAYER_SSM:
        p.update(ssm_mod.ssm_init(gen, cfg))
    elif kind == LAYER_MOE:
        p.update(moe_mod.moe_init(gen, cfg))
    else:
        p.update(attn.gqa_init(gen, cfg))
    return p


def _pattern_init(gen: torch.Generator, cfg, dtype) -> dict:
    """Each layer drawn in pattern order, one at a time (f32), and
    written in ``dtype`` into its kind's stack: no f32 copy of more than
    one layer's leaf."""
    out: dict = {}
    for (name, j), kind in zip(layer_slots(cfg), cfg.layer_kinds()):
        layer = _mixer_init(gen, cfg, kind)
        if name not in out:
            n = cfg.layer_kinds().count(kind)
            out[name] = _tree.tree_map(lambda a: torch.empty(
                (n,) + tuple(a.shape), dtype=dtype or a.dtype,
                device=a.device), layer)
        for dst, src in zip(_tree.leaves(out[name]), _tree.leaves(layer)):
            dst[j].copy_(src)
    return out


def stack_init(gen: torch.Generator, cfg, n_layers: int,
               dtype=None) -> dict:
    """The stacked layers' params in f32, or of a pattern config in
    ``dtype`` (layer by layer)."""
    if _is_pattern(cfg):
        return _pattern_init(gen, cfg, dtype)
    return _tree.stack_trees(lambda: block_init(gen, cfg), n_layers)


ROWS_BACKLOG = 256      # busiest-expert counts left on the card at most
_ROWS_MAX: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _note_rows_max(tel, layer: int, rows) -> None:
    """Add ``rows`` (a device scalar) to ``serve.moe_rows_max{layer}`` of
    ``tel``'s registry when it is next snapshotted (a collector), so
    nothing waits for the card here; past ``ROWS_BACKLOG`` pending, the
    older half is added now (long since computed)."""
    entry = _ROWS_MAX.get(tel)
    if entry is None:
        pending: list = []

        def collect(reg, n=None):
            done = pending[:n]
            del pending[:len(done)]
            for lay, r in done:
                reg.counter("serve.moe_rows_max", layer=lay).inc(int(r))
        tel.metrics.register_collector(collect)
        entry = _ROWS_MAX[tel] = (pending, collect)
    pending, collect = entry
    pending.append((layer, rows))
    if len(pending) > ROWS_BACKLOG:
        collect(tel.metrics, ROWS_BACKLOG // 2)


def _moe_serve(cfg, p: dict, h, layer: int):
    """A served MoE layer in span ``serve.moe``: counts its routed rows
    (``serve.moe_rows{layer}``, always; a replayed decode graph runs no
    Python, so its steps are not counted) and, while the telemetry
    records, its busiest expert's rows (``serve.moe_rows_max{layer}``,
    resolved at the registry's ``snapshot()``)."""
    # repro_torch.core imports this module: import its telemetry late
    from repro_torch.core.telemetry import current
    tel = current()
    rows = h.shape[0] * h.shape[1] * cfg.moe.top_k
    tel.metrics.counter("serve.moe_rows", layer=layer).inc(rows)
    stats = {} if tel.recording else None
    with tel.span("serve.moe", cat="serve", device=h.device,
                  attrs={"layer": layer, "rows": rows}):
        y, _ = moe_mod.moe_apply(p, cfg, batch_only(h), stats=stats)
    if stats:
        _note_rows_max(tel, layer, stats["rows_max"])
    return y


def _pattern_layer(cfg, kind: str, i: int, p: dict, x, serve):
    """Pattern layer ``i`` of a served step: ``serve(kind, p, h)`` runs
    the M and * mixers (prefill or decode) and returns (y, cache); the E
    mixer runs here. Returns (x, cache or None)."""
    # repro_torch.core imports this module: import its telemetry late
    from repro_torch.core.telemetry import current
    h = batch_only(rms_norm(x, p["norm"], cfg.norm_eps))
    if kind == LAYER_MOE:
        return x + _moe_serve(cfg, p, h, i), None
    name = "serve.ssm" if kind == LAYER_SSM else "serve.attention"
    with current().span(name, cat="serve", device=x.device):
        y, cache = serve(kind, p, h)
    return x + y, cache


def stack_apply(cfg, stacked: dict, x: torch.Tensor,
                positions: torch.Tensor, windows, *, impl: str = "xla",
                remat: bool = True):
    """windows: (L,) ints. Returns (x, total_aux). With ``remat`` (and
    autograd recording) each layer body is checkpointed, as the
    reference's ``jax.checkpoint`` of its scan body: the backward keeps
    each layer's input and runs the layer again."""
    if _is_pattern(cfg):
        raise ValueError(f"{cfg.name}: a layer_pattern config is served "
                         f"(prefill, decode), not trained")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for w, lp in zip(np.asarray(windows).tolist(), placed_layers(stacked)):
        def body(x_, pos_, lp=lp, w=int(w)):
            return block_apply(cfg, lp, x_, pos_, w, impl=impl)
        x, a = (checkpointed(body, x, positions) if remat
                else body(x, positions))
        aux = aux + a
    return x, aux


def _pattern_prefill(cfg, stacked: dict, x, positions, cache_len: int, *,
                     stack, impl: str):
    """``stack_prefill`` of a pattern config: each kind's caches stacked
    by ``stack(trees, name)``."""
    def serve(kind, p, h):
        if kind == LAYER_SSM:
            return ssm_mod.ssm_prefill(p, cfg, h, impl=impl)
        return attn.gqa_prefill(p, cfg, h, positions, window=0,
                                cache_len=cache_len, impl=impl)
    caches: dict = {}
    for i, ((name, j), kind) in enumerate(zip(layer_slots(cfg),
                                              cfg.layer_kinds())):
        x, cache = _pattern_layer(cfg, kind, i, _tree.index(stacked[name], j),
                                  x, serve)
        if cache is not None:
            caches.setdefault(name, []).append(cache)
    return x, {name: stack(trees, name) for name, trees in caches.items()}


def _pattern_decode(cfg, stacked: dict, x, caches: dict, positions):
    """``stack_decode`` of a pattern config."""
    def serve(kind, p, h, views=None):
        if kind == LAYER_SSM:
            return ssm_mod.ssm_decode(p, cfg, h, views)
        return attn.gqa_decode(p, cfg, h, views, positions, window=0)
    for i, ((name, j), kind) in enumerate(zip(layer_slots(cfg),
                                              cfg.layer_kinds())):
        p = _tree.index(stacked[name], j)
        if kind == LAYER_MOE:
            x, _ = _pattern_layer(cfg, kind, i, p, x, serve)
            continue
        views, orig = attn.layer_views(caches[name], j)
        x, _ = _pattern_layer(cfg, kind, i, p, x,
                              lambda k, p_, h, v=views: serve(k, p_, h, v))
        attn.put_back(caches[name], j, views, orig)
    return x, caches


def stack_prefill(cfg, stacked: dict, x: torch.Tensor,
                  positions: torch.Tensor, windows, cache_len: int, *,
                  stack, impl: str = "xla"):
    """Returns (x, stacked caches with leading (L,) axis): the layers'
    caches stacked by ``stack`` (a list of trees -> one tree; of a
    pattern config ``stack(trees, kind name)`` a kind)."""
    if _is_pattern(cfg):
        return _pattern_prefill(cfg, stacked, x, positions, cache_len,
                                stack=stack, impl=impl)
    caches = []
    for i, w in enumerate(np.asarray(windows).tolist()):
        x, cache = block_prefill(cfg, _tree.index(stacked, i), x, positions,
                                 int(w), cache_len, impl=impl)
        caches.append(cache)
    return x, stack(caches)


def stack_decode(cfg, stacked: dict, x: torch.Tensor, caches: dict,
                 positions: torch.Tensor, windows):
    """caches: tree with leading (L,) axis, updated in place. Returns
    (x, caches)."""
    if _is_pattern(cfg):
        return _pattern_decode(cfg, stacked, x, caches, positions)
    for i, w in enumerate(np.asarray(windows).tolist()):
        views, orig = attn.layer_views(caches, i)
        x, _ = block_decode(cfg, _tree.index(stacked, i), x, views,
                            positions, int(w))
        attn.put_back(caches, i, views, orig)
    return x, caches


def stack_cache_init(cfg, batch: int, cache_len: int, dtype, n_layers: int,
                     device, *, stack) -> dict:
    """A zero cache of ``n_layers`` layers, their trees stacked by
    ``stack`` (a list of trees -> one tree; of a pattern config, a kind's
    layers)."""
    if _is_pattern(cfg):
        kinds = cfg.layer_kinds()
        one = {"mamba": (LAYER_SSM, lambda: ssm_mod.ssm_cache_init(
                   cfg, batch, dtype, device)),
               "attention": (LAYER_ATTN, lambda: attn.gqa_cache_init(
                   cfg, batch, cache_len, dtype, device))}
        return {name: stack([make()] * kinds.count(k))
                for name, (k, make) in one.items() if k in kinds}
    return stack([block_cache_init(cfg, batch, cache_len, dtype, device)]
                 * n_layers)
