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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


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


def moe_apply(p: dict, cfg, x: torch.Tensor):
    """x: (B,S,D) -> (out (B,S,D), aux_loss)."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    T = B * S
    dt, dev = x.dtype, x.device
    xf = x.reshape(T, D)

    logits = xf @ p["router"].to(dt)                     # (T,E)
    w, idx, aux = router_topk(logits, K)                 # (T,K)

    cap = capacity(cfg, T)
    # flatten the assignments and sort them by expert id (stable: an
    # earlier token has priority within its expert)
    flat_e = idx.reshape(-1)                             # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], w.reshape(-1)[order]
    group_start = torch.searchsorted(se, torch.arange(E, device=dev))
    pos_in_group = torch.arange(T * K, device=dev) - group_start[se]
    keep = pos_in_group < cap
    slot = torch.where(keep, se * cap + pos_in_group, E * cap)   # overflow

    # (E*C, D) buffers; the overflow row takes the dropped writes and goes
    buf = torch.zeros((E * cap + 1, D), dtype=dt, device=dev)
    buf[slot] = xf[st]
    buf = buf[:-1].reshape(E, cap, D)

    h = torch.bmm(buf, p["w_gate"].to(dt))
    u = torch.bmm(buf, p["w_up"].to(dt))
    y = torch.bmm(F.silu(h) * u, p["w_down"].to(dt))    # (E,C,D)

    y_flat = y.reshape(E * cap, D)
    contrib = torch.where(
        keep[:, None], y_flat[torch.clamp(slot, max=E * cap - 1)]
        * sw[:, None].to(dt), torch.zeros((), dtype=dt, device=dev))
    # each token's K contributions, in ascending expert order
    by_token = contrib[torch.argsort(st, stable=True)].reshape(T, K, D)
    out = by_token[:, 0]
    for k in range(1, K):
        out = out + by_token[:, k]
    return out.reshape(B, S, D), aux * m.router_aux_weight
