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

A ``dropless`` config (Nemotron-H's MoE) dispatches without capacity
(``_moe_dropless``): the (token, expert) rows sorted by expert (stable:
within an expert, earlier tokens first), each expert's row count found on
the card by ``searchsorted``, and one grouped product an expert
projection (``grouped_mm``: ``torch._grouped_mm`` on CUDA) over the
sorted rows; no (E, C, D) buffer and no host sync, so a decode step stays
capturable (``models/decode_graph.py``). The top-k ties and the per-token
sum keep the two orders above. It routes by ``_router_sigmoid``, its
experts are relu², and a ``d_shared`` relu² expert is added to every
token. The capacity dispatch takes only the reference's MoE (softmax,
SwiGLU, no shared expert); ``_check_options`` holds each to its own.

Over a mesh of ranks (``DTensor`` tokens and expert weights) the expert
buffers stay sharded, as the reference's constraints keep them: the
dispatch plan, a few (T, K) index arrays, is computed whole on every
rank, and each rank fills only its own block of the (E, C, D) buffers
(its experts, over the mesh dims that split the expert weights, and its
share of the capacity slots, or of the groups, over the dims that split
the tokens), multiplies it by its own experts' weights, and adds its
slots' weighted outputs into a partial (T, D) that one reduction brings
to the tokens' placement (``_experts_over_ranks``). No rank holds a
whole buffer. Within a rank each token's contributions are added in
ascending expert order; across ranks the partials are summed by the
collective.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.models.layers import dense_init
from repro_torch.sharding.specs import (P, constrain, contiguous_stride,
                                        replicated_call)


def moe_init(gen: torch.Generator, cfg) -> dict:
    m = cfg.moe
    _check_options(m)
    D, E, F_ = cfg.d_model, m.num_experts, m.d_expert
    p = {"router": dense_init(gen, (D, E))}
    if m.activation == "swiglu":
        p["w_gate"] = dense_init(gen, (E, D, F_))
    p["w_up"] = dense_init(gen, (E, D, F_))
    p["w_down"] = dense_init(gen, (E, F_, D))
    if m.score_bias:
        p["router_bias"] = torch.zeros(E, dtype=torch.float32,
                                       device=gen.device)
    if m.d_shared:
        p["shared_up"] = dense_init(gen, (D, m.d_shared))
        p["shared_down"] = dense_init(gen, (m.d_shared, D))
    return p


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


def moe_apply(p: dict, cfg, x: torch.Tensor, stats=None):
    """x: (B,S,D) -> (out (B,S,D), aux_loss). A dropless config fills
    ``stats`` (a dict) with ``rows_max``, its busiest expert's rows (a
    device scalar)."""
    _check_options(cfg.moe)
    if cfg.moe.dropless:
        return _moe_dropless(p, cfg, x, stats)
    G = int(os.environ.get("REPRO_MOE_GROUPED", "1"))
    if G > 1:
        return _moe_apply_grouped(p, cfg, x, G)
    over_ranks = _over_ranks(x, p)
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    T = B * S
    dt = x.dtype
    xf = x.reshape(T, D)

    logits = xf @ p["router"].to(dt)                     # (T,E)
    w, idx, aux = router_topk(logits, K)                 # (T,K)

    cap = capacity(cfg, T)
    # the plan's sort runs on whole (T, K) routings (``replicated_call``:
    # over ranks it has no sharding rule)
    st, sw, slot, keep = replicated_call(_dispatch_plan, idx, w, E, cap)
    if over_ranks:
        out = _experts_over_ranks(p, dt, xf, _ByToken(st, sw, slot, keep, K),
                                  (E, cap), cap)
        return out.reshape(B, S, D), aux * m.router_aux_weight
    buf = _fill_buffers(xf, st, slot, E, cap)

    h = torch.bmm(buf, p["w_gate"].to(dt))
    u = torch.bmm(buf, p["w_up"].to(dt))
    y = torch.bmm(F.silu(h) * u, p["w_down"].to(dt))    # (E,C,D)

    out = _combine(y, st, sw, slot, keep, T, K)
    return out.reshape(B, S, D), aux * m.router_aux_weight


def _over_ranks(tokens, p: dict) -> bool:
    """Tokens and expert weights are ``DTensor``s (the sharded dispatch),
    or all plain tensors (the one-process one); a mix raises."""
    over = [isinstance(a, DTensor) for a in
            (tokens, p["w_gate"], p["w_up"], p["w_down"])]
    if any(over) and not all(over):
        raise ValueError("the MoE dispatch takes tokens and expert weights "
                         "that are all DTensors or all plain tensors")
    return all(over)


class _ByToken:
    """A dispatch plan (the sorted assignments of ``_dispatch_plan`` or
    ``_grouped_plan``, replicated ``DTensor``s) as local arrays, both in
    the plan's order (``st``, ``sorted_slot``, ``sorted_keep``) and by
    token: each token's K slots and whether they are kept, in ascending
    expert order (``slot``, ``keep``: (..., T, K)). A leading group dim
    leads every array. ``sw``, the weights, stays a replicated
    ``DTensor``: its gradient is a partial sum over the ranks that split
    the buffers."""

    def __init__(self, st, sw, slot, keep, K: int):
        self.st, self.sorted_slot, self.sorted_keep = (
            a.to_local() for a in (st, slot, keep))
        self.sw, self.K = sw, K
        order = torch.argsort(self.st, dim=-1, stable=True)
        lead = self.st.shape[:-1]
        self.slot, self.keep = (
            torch.gather(a, -1, order).reshape(*lead, -1, K)
            for a in (self.sorted_slot, self.sorted_keep))


def _split(tokens: DTensor, w: DTensor, *, groups: bool):
    """How the mesh splits the (E, C, D) buffers ((G, E, C, D) with
    ``groups``) over ranks, one entry a mesh dim: a dim that splits the
    expert weights' expert dim splits the buffers' expert dim; one that
    splits the tokens (dim 0) splits the capacity slots (the groups); any
    other holds the whole block, as every rank of it computes the same.
    Returns the buffers' placements, the tokens' placements in which each
    rank reads them (the groups its block needs, or all tokens) and in
    which its partial result stands, the plan's grad placements, and the
    expert weights' placements and grad placements."""
    buf, tok, out, plan, w_pl, w_grad = [], [], [], [], [], []
    for tp, wp in zip(tokens.placements, w.placements):
        if isinstance(wp, Shard) and wp.dim == 0:          # experts
            buf.append(Shard(1 if groups else 0))
            tok.append(Replicate())
            out.append(Partial())
            plan.append(Partial())
            w_pl.append(Shard(0))
            w_grad.append(Shard(0))
        elif isinstance(tp, Shard) and tp.dim == 0:        # slots / groups
            buf.append(Shard(0 if groups else 1))
            tok.append(Shard(0) if groups else Replicate())
            out.append(Shard(0) if groups else Partial())
            plan.append(Partial())
            w_pl.append(Replicate())
            w_grad.append(Partial())
        else:
            for lst in (buf, tok, out, plan, w_pl, w_grad):
                lst.append(Replicate())
    return buf, tok, out, plan, w_pl, w_grad


def _local_mlp(p: dict, dt, buf: torch.Tensor, w_pl, w_grad):
    """This rank's experts' SwiGLU over its (..., E_l, C, D) buffer block;
    each expert weight is gathered to ``w_pl`` (its experts whole) and its
    gradient comes back as ``w_grad`` (partial over the ranks that split
    the slots)."""
    def local(k):
        w = p[k].to(dt)
        return w.redistribute(w.device_mesh, w_pl).to_local(
            grad_placements=w_grad)
    h = torch.matmul(buf, local("w_gate"))
    u = torch.matmul(buf, local("w_up"))
    return torch.matmul(F.silu(h) * u, local("w_down"))


def _experts_over_ranks(p: dict, dt, xf: DTensor, plan: _ByToken,
                        grid: tuple, cap: int, *, groups: bool = False):
    """The expert FFN over ranks, its buffers sharded. ``xf``: (T, D)
    tokens, or (G, Tg, D) token groups; ``grid``: the buffers' (E, cap)
    ((G, E, cap) with ``groups``). Each rank fills its block of the
    buffers from the tokens it reads, runs its experts on it, and adds
    its slots' weighted outputs into each token's row (ascending expert
    order) of a partial result, which one reduction brings to ``xf``'s
    placement."""
    mesh = xf.device_mesh
    D = xf.shape[-1]
    buf_pl, tok_pl, out_pl, plan_pl, w_pl, w_grad = _split(
        xf, p["w_gate"], groups=groups)
    shape, offset = compute_local_shape_and_global_offset(
        tuple(grid) + (D,), mesh, buf_pl)
    g0, ng = (offset[0], shape[0]) if groups else (0, 1)
    e0, ne, c0, nc = offset[-3], shape[-3], offset[-2], shape[-2]
    n = ne * nc
    xw = xf.redistribute(mesh, tok_pl).to_local(grad_placements=out_pl)
    if not groups:
        xw = xw[None]

    def rows(a):                   # the plan's rows of this rank's groups
        return a[g0:g0 + ng] if groups else a[None]
    sw = rows(plan.sw.to_local(grad_placements=plan_pl))
    lslot, hit = _local_slot(rows(plan.sorted_slot), rows(plan.sorted_keep),
                             cap, e0, ne, c0, nc)
    # each local buffer slot's token and weight (the overflow slot n takes
    # what falls outside the block, and goes)
    g_idx = torch.arange(ng, device=lslot.device)[:, None].expand_as(lslot)
    tok = torch.zeros((ng, n + 1), dtype=torch.long, device=lslot.device)
    tok[g_idx, lslot] = rows(plan.st)
    filled = torch.zeros((ng, n + 1), dtype=torch.bool, device=lslot.device)
    filled[g_idx, lslot] = hit
    wgt = torch.zeros((ng, n + 1), dtype=sw.dtype,
                      device=lslot.device).index_put((g_idx, lslot), sw)
    zero = torch.zeros((), dtype=dt, device=lslot.device)
    # F.embedding, not advanced indexing: its backward adds in a fixed
    # order (``Model._embed_tokens``)
    buf = torch.where(filled[:, :n, None], torch.stack(
        [F.embedding(tok[g, :n], xw[g]) for g in range(ng)]), zero)
    y = _local_mlp(p, dt, buf.reshape(ng, ne, nc, D), w_pl, w_grad)
    yw = y.reshape(ng, n, D) * wgt[:, :n, None].to(dt)
    at, hit = _local_slot(rows(plan.slot), rows(plan.keep), cap, e0, ne, c0,
                          nc)
    at = torch.clamp(at, max=n - 1)
    out = None
    for j in range(plan.K):
        c = torch.where(hit[..., j, None], torch.stack(
            [F.embedding(at[g, :, j], yw[g]) for g in range(ng)]), zero)
        out = c if out is None else out + c
    if not groups:
        out = out[0]
    out = DTensor.from_local(out, mesh, out_pl, run_check=False,
                             shape=xf.shape, stride=contiguous_stride(xf.shape))
    return out.redistribute(mesh, xf.placements)


def _local_slot(slot, keep, cap: int, e0: int, ne: int, c0: int, nc: int):
    """Buffer slots ``e * cap + c`` as this rank's block's local
    ``(e - e0) * nc + (c - c0)``, and whether each is kept and in the
    block; the others point at the overflow slot ``ne * nc``."""
    e, c = torch.div(slot, cap, rounding_mode="floor"), slot % cap
    hit = keep & (e >= e0) & (e < e0 + ne) & (c >= c0) & (c < c0 + nc)
    return torch.where(hit, (e - e0) * nc + (c - c0), ne * nc), hit


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
    over_ranks = _over_ranks(x, p)
    # the groups over "data" before the view: the stream may be split on
    # its batch over "model" too, which the view cannot regroup
    xg = constrain(constrain(x, P("data", None, None)).reshape(G, Tg, D),
                   P("data", None, None))

    logits = xg @ p["router"].to(dt)                     # (G,Tg,E)
    w, idx, aux = router_topk(logits.reshape(T, E), K)   # (T,K)

    cap = max(8, min(int(m.capacity_factor * Tg * K / E), Tg))
    st, sw, slot, keep = replicated_call(_grouped_plan, idx, w, G, E, cap)
    if over_ranks:
        out = _experts_over_ranks(p, dt, xg, _ByToken(st, sw, slot, keep, K),
                                  (G, E, cap), cap, groups=True)
        # placed after the view too, so the backward regroups no stream
        # split on its batch over "model"
        return (constrain(out.reshape(B, S, D), P("data", None, None)),
                aux * m.router_aux_weight)
    buf = constrain(_grouped_fill(xg, st, slot, E, cap),
                    P("data", "model", None, None))

    h = torch.einsum("gecd,edf->gecf", buf, p["w_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", buf, p["w_up"].to(dt))
    y = torch.einsum("gecf,efd->gecd", F.silu(h) * u, p["w_down"].to(dt))
    y = constrain(y, P("data", "model", None, None))

    out = constrain(_grouped_combine(y, st, sw, slot, keep, K),
                    P("data", None, None))
    return out.reshape(B, S, D), aux * m.router_aux_weight


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


# ---------------------------------------------------------------------------
# dropless dispatch (sigmoid router, relu² experts, a shared expert)
# ---------------------------------------------------------------------------
def _router_sigmoid(p: dict, m, xf: torch.Tensor):
    """xf: (T,D) -> (weights (T,K) f32, idx (T,K) int64). The logits in
    f32; sigmoid scores; the top k of scores plus ``router_bias`` (ties
    to the lower expert), the bias picking and not weighing; the picked
    scores normalised to sum 1 and scaled by ``routed_scale``."""
    scores = torch.sigmoid(xf.to(torch.float32)
                           @ p["router"].to(torch.float32))
    choice = (scores + p["router_bias"].to(torch.float32)
              if "router_bias" in p else scores)
    _, idx = torch.sort(choice, dim=-1, descending=True, stable=True)
    idx = idx[:, :m.top_k]
    w = torch.gather(scores, 1, idx)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-20)
    return w * m.routed_scale, idx


def grouped_mm(a: torch.Tensor, w: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """a: (R, K) rows sorted by group; w: (G, K, N); ends: (G,) int32,
    the end row of each group (a running count). -> (R, N): each group's
    rows times its matrix. On CUDA ``torch._grouped_mm`` (the ends stay
    on the card); elsewhere a plain product a group."""
    if a.is_cuda:
        return torch._grouped_mm(a, w, offs=ends)
    out = a.new_empty((a.shape[0], w.shape[-1]))
    start = 0
    for g, end in enumerate(ends.tolist()):
        out[start:end] = a[start:end] @ w[g]
        start = end
    return out


def _check_options(m) -> None:
    """The capacity dispatch computes the reference's MoE (softmax router,
    SwiGLU experts, no score bias, routed scale or shared expert); the
    dropless one Nemotron-H's (sigmoid router, relu² experts)."""
    if m.dropless:
        ok = (m.router, m.activation) == ("sigmoid", "relu2")
    else:
        ok = (m.router, m.activation, m.score_bias, m.routed_scale,
              m.d_shared) == ("softmax", "swiglu", False, 1.0, 0)
    if not ok:
        raise ValueError(f"{m}: the capacity dispatch takes a softmax "
                         f"router and SwiGLU experts alone, the dropless "
                         f"one a sigmoid router and relu2 experts")


def _relu2_mlp(rows, up, down, mm=torch.matmul):
    """``down(relu(rows @ up)^2)``."""
    return mm(torch.square(F.relu(mm(rows, up))), down)


def _moe_dropless(p: dict, cfg, x: torch.Tensor, stats=None):
    """Every (token, expert) pick computed: rows sorted by expert, the
    grouped products, the weighted rows summed a token in ascending
    expert order in f32, then the shared expert added. No aux loss."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    T = B * S
    dt = x.dtype
    xf = x.reshape(T, D)
    w, idx = _router_sigmoid(p, m, xf)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    st = torch.div(order, K, rounding_mode="floor")       # each row's token
    ends = torch.searchsorted(
        flat_e[order], torch.arange(E, device=x.device),
        right=True).to(torch.int32)
    if stats is not None:
        stats["rows_max"] = torch.max(torch.diff(ends, prepend=ends[:1] * 0))
    y = _relu2_mlp(xf[st], p["w_up"].to(dt), p["w_down"].to(dt),
                   lambda a, b: grouped_mm(a, b, ends))
    contrib = y.to(torch.float32) * w.reshape(-1)[order][:, None]
    out = _sum_by_token(contrib, st, T, K).to(dt)
    if "shared_up" in p:
        out = out + _relu2_mlp(xf, p["shared_up"].to(dt),
                               p["shared_down"].to(dt))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return out.reshape(B, S, D), aux
