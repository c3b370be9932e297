"""Mixture-of-Experts layer: top-k router and sort-based capacity dispatch
(port of ``repro.models.moe``, its global "sort" dispatch).

Flatten the tokens, take the router's top k, sort the (token, expert)
assignments by expert id, and fill per-expert capacity buffers with a
gather; one batched product over the (E, C, D) buffers; the results go
back to their tokens weighted by the router's probabilities. Assignments
past an expert's capacity are dropped (Switch semantics:
``capacity_factor`` sets the drop rate), which makes a prefill (many
tokens) and a decode step (a few) route differently at the published
factors.

Three orders are fixed to the reference's, so that equal inputs route
and sum alike:
  * top-k ties go to the lower expert index first, as
    ``jax.lax.top_k``'s (a stable descending sort; ``torch.topk``
    promises no order on ties, and bf16 router logits do tie);
  * the capacity order is a stable argsort by expert and a left
    ``searchsorted``: within an expert, earlier tokens keep their slots;
  * each token's contributions are added in ascending expert order, the
    order of the reference's ``.at[st].add`` over the sorted assignments,
    one add at a time in the compute dtype, with no atomics: the served
    tokens repeat run to run.
The expert products are plain batched products (``torch.bmm``), as the
reference leaves them to XLA outside any kernel.

``REPRO_MOE_GROUPED=<G>`` (read at call time, as the reference reads it)
switches to the group-local dispatch ``_moe_apply_grouped``: the tokens
split into G groups (the data-parallel shards of a mesh) and each group
fills its own capacity buffers, with the same three orders inside a
group.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.layers import dense_init
from repro_torch.sharding.specs import (P, constrain, contiguous_stride,
                                        replicated_call)


def moe_init(gen: torch.Generator, cfg) -> dict:
    m = cfg.moe
    D, E, F_ = cfg.d_model, m.num_experts, m.d_expert
    return {
        "router": dense_init(gen, (D, E)),
        "w_gate": dense_init(gen, (E, D, F_)),
        "w_up": dense_init(gen, (E, D, F_)),
        "w_down": dense_init(gen, (E, F_, D)),
    }


def router_topk(logits: torch.Tensor, top_k: int):
    """logits: (T,E) -> (weights (T,K) f32, idx (T,K) int64, aux_loss)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :top_k], idx[:, :top_k]
    w = w / torch.sum(w, dim=-1, keepdim=True)          # renormalize top-k
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    E = logits.shape[-1]
    me = torch.mean(probs, dim=0)                        # mean router prob
    ce = torch.mean(torch.sum(F.one_hot(idx, E).to(torch.float32), dim=1),
                    dim=0)
    return w, idx, E * torch.sum(me * ce)


def capacity(cfg, n_tokens: int) -> int:
    """Slots an expert has for ``n_tokens`` tokens (at least 8, at most
    ``n_tokens``)."""
    m = cfg.moe
    cap = int(m.capacity_factor * n_tokens * m.top_k / m.num_experts)
    return max(8, min(cap, n_tokens))


def _sum_by_token(contrib: torch.Tensor, st: torch.Tensor, n: int,
                  k: int) -> torch.Tensor:
    """(n*k, D) contributions of the sorted assignments -> (n, D): each
    token's k contributions added in ascending expert order."""
    by_token = contrib[torch.argsort(st, stable=True)].reshape(n, k, -1)
    out = by_token[:, 0]
    for j in range(1, k):
        out = out + by_token[:, j]
    return out


def moe_apply(p: dict, cfg, x: torch.Tensor):
    """x: (B,S,D) -> (out (B,S,D), aux_loss)."""
    G = int(os.environ.get("REPRO_MOE_GROUPED", "1"))
    if G > 1:
        return _moe_apply_grouped(p, cfg, x, G)
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    T = B * S
    dt = x.dtype
    xf = x.reshape(T, D)

    logits = xf @ p["router"].to(dt)                     # (T,E)
    w, idx, aux = router_topk(logits, K)                 # (T,K)

    cap = capacity(cfg, T)
    # the sort, the scatter into the expert buffers and the gather back
    # run on whole tensors (``replicated_call``: over ranks they have no
    # sharding rule); the expert matmuls between them stay sharded
    st, sw, slot, keep = replicated_call(_dispatch_plan, idx, w, E, cap)
    buf = replicated_call(_fill_buffers, xf, st, slot, E, cap)

    h = torch.bmm(buf, p["w_gate"].to(dt))
    u = torch.bmm(buf, p["w_up"].to(dt))
    y = torch.bmm(F.silu(h) * u, p["w_down"].to(dt))    # (E,C,D)

    out = replicated_call(_combine, y, st, sw, slot, keep, T, K)
    return out.reshape(B, S, D), aux * m.router_aux_weight


def _dispatch_plan(idx: torch.Tensor, w: torch.Tensor, E: int, cap: int):
    """The (T, K) assignments flattened and sorted by expert id (stable:
    an earlier token has priority within its expert): each one's token,
    weight, buffer slot (``E * cap`` for a dropped one) and whether it is
    kept."""
    T, K = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1)                             # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], w.reshape(-1)[order]
    group_start = torch.searchsorted(se, torch.arange(E, device=dev))
    pos_in_group = torch.arange(T * K, device=dev) - group_start[se]
    keep = pos_in_group < cap
    slot = torch.where(keep, se * cap + pos_in_group, E * cap)   # overflow
    return st, sw, slot, keep


def _fill_buffers(xf: torch.Tensor, st, slot, E: int, cap: int):
    """(E, cap, D) expert buffers; the overflow row takes the dropped
    writes and goes."""
    D = xf.shape[1]
    buf = torch.zeros((E * cap + 1, D), dtype=xf.dtype, device=xf.device)
    buf[slot] = xf[st]
    return buf[:-1].reshape(E, cap, D)


def _combine(y: torch.Tensor, st, sw, slot, keep, T: int, K: int):
    """Each token's kept expert outputs, weighted, summed in ascending
    expert order: (T, D)."""
    E, cap, D = y.shape
    dt = y.dtype
    y_flat = y.reshape(E * cap, D)
    contrib = torch.where(
        keep[:, None], y_flat[torch.clamp(slot, max=E * cap - 1)]
        * sw[:, None].to(dt), torch.zeros((), dtype=dt, device=y.device))
    return _sum_by_token(contrib, st, T, K)


def _moe_apply_grouped(p: dict, cfg, x: torch.Tensor, G: int):
    """Group-local dispatch: (B,S,D) -> G groups of T/G tokens, each
    filling (E, C, D) buffers from its own tokens, with its own capacity
    ``max(8, min(int(cf * Tg * K / E), Tg))``. The aux loss is the global
    one (its means run over every group's tokens). The reference's
    constraints (groups over "data", expert buffers over "data" and
    "model") apply inside ``mesh_scope``; with no mesh they are the
    identity."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    T = B * S
    if T % G:
        raise ValueError(f"{G} token groups do not divide {T} tokens")
    Tg = T // G
    dt = x.dtype
    xg = constrain(x.reshape(G, Tg, D), P("data", None, None))

    logits = xg @ p["router"].to(dt)                     # (G,Tg,E)
    w, idx, aux = router_topk(logits.reshape(T, E), K)   # (T,K)

    cap = max(8, min(int(m.capacity_factor * Tg * K / E), Tg))
    st, sw, slot, keep = replicated_call(_grouped_plan, idx, w, G, E, cap)
    buf = constrain(replicated_call(_grouped_fill, xg, st, slot, E, cap),
                    P("data", "model", None, None))

    h = _experts("gecd,edf->gecf", buf, p["w_gate"].to(dt))
    u = _experts("gecd,edf->gecf", buf, p["w_up"].to(dt))
    y = _experts("gecf,efd->gecd", F.silu(h) * u, p["w_down"].to(dt))
    y = constrain(y, P("data", "model", None, None))

    out = constrain(replicated_call(_grouped_combine, y, st, sw, slot, keep,
                                    K), P("data", None, None))
    return out.reshape(B, S, D), aux * m.router_aux_weight


def _experts(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, x, w)`` of (G, E, C, .) buffers with (E, ., .) expert
    weights. Over ranks each rank multiplies its own groups and experts
    (the buffers' placement; the weights gathered to match), so the
    expert compute is local, as the reference's constraints make it."""
    if not isinstance(x, DTensor):
        return torch.einsum(eq, x, w)
    mesh = x.device_mesh
    if any(not isinstance(p, (Shard, Replicate)) or
           (isinstance(p, Shard) and p.dim > 1) for p in x.placements):
        raise ValueError(f"expert buffers placed {x.placements}: groups "
                         "and experts only")
    w_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 1 else Replicate()
            for p in x.placements]
    out = torch.einsum(eq, x.to_local(), w.redistribute(mesh, w_pl).to_local())
    shape = tuple(x.shape[:3]) + (w.shape[-1],)
    return DTensor.from_local(out, mesh, x.placements, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def _grouped_plan(idx: torch.Tensor, w: torch.Tensor, G: int, E: int,
                  cap: int):
    """``_dispatch_plan`` within each of G token groups: (G, Tg*K)."""
    T, K = idx.shape
    Tg = T // G
    dev = idx.device
    flat_e = idx.reshape(G, Tg * K)
    flat_t = torch.arange(Tg, device=dev).repeat_interleave(K).expand(
        G, Tg * K)
    flat_w = w.reshape(G, Tg * K)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = torch.gather(flat_t, 1, order)
    sw = torch.gather(flat_w, 1, order)
    arange_e = torch.arange(E, device=dev).expand(G, E).contiguous()
    group_start = torch.searchsorted(se, arange_e)       # (G,E)
    pos = torch.arange(Tg * K, device=dev)[None] - torch.gather(
        group_start, 1, se)
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, E * cap)
    return st, sw, slot, keep


def _grouped_fill(xg: torch.Tensor, st, slot, E: int, cap: int):
    """(G, E, cap, D) buffers, group by group."""
    G, _, D = xg.shape
    g_idx = torch.arange(G, device=xg.device)[:, None]
    buf = torch.zeros((G, E * cap + 1, D), dtype=xg.dtype, device=xg.device)
    buf[g_idx, slot] = xg[g_idx, st]
    return buf[:, :-1].reshape(G, E, cap, D)


def _grouped_combine(y: torch.Tensor, st, sw, slot, keep, K: int):
    """(G, Tg, D): ``_combine`` within each group."""
    G, E, cap, D = y.shape
    dt = y.dtype
    Tg = st.shape[1] // K
    g_idx = torch.arange(G, device=y.device)[:, None]
    y_flat = y.reshape(G, E * cap, D)
    gathered = y_flat[g_idx, torch.clamp(slot, max=E * cap - 1)]
    contrib = torch.where(keep[..., None], gathered * sw[..., None].to(dt),
                          torch.zeros((), dtype=dt, device=y.device))
    return torch.stack([_sum_by_token(contrib[g], st[g], Tg, K)
                        for g in range(G)])
