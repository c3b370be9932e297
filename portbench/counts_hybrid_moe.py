"""The benchmark's counts of the work of a Nemotron-H prefill: Mamba2, MoE
and attention layers by ``layer_pattern``.

Counted from the configuration's sizes, whatever implements a layer, as
``counts.py`` counts: 2 FLOPs a multiply-add of a projection; attention as
4 * head_dim FLOPs a head for each visible (query, key) pair; the scan as
its recurrence, 5 * d_head * d_state FLOPs a token and head; each input
byte read once and each output byte written once; norms, the router's
sort and other elementwise work not counted. An MoE layer's experts count
the picked rows only (top k a token, dropless), and its shared expert
every token.

``prefill`` gives the counts a traced run's readers take: the whole
prefill (``prefill``), the routed experts' grouped products
(``expert_mm``) and K7's scans (``k7``), each ``{"flops", "bytes",
"precision"}``.
"""
from __future__ import annotations

from portbench.counts import BF16, F32, TOKEN, attention_pairs


def _layers(cfg: dict) -> dict:
    pat = cfg["layer_pattern"]
    return {k: pat.count(k) for k in "ME*"}


def _ssm(cfg: dict):
    s = cfg["ssm"]
    H, P, G, N = cfg["ssm_heads"], s["d_head"], cfg["ssm_groups"], \
        s["d_state"]
    d_inner = H * P
    return H, P, G, N, d_inner, d_inner + 2 * G * N, s["d_conv"]


def layer_macs(cfg: dict) -> dict:
    """Multiply-adds a token costs in one layer of each kind's
    projections (an MoE layer's top k experts, its shared expert and its
    router)."""
    D = cfg["d_model"]
    H, _, _, _, d_inner, d_xbc, _ = _ssm(cfg)
    m = cfg["moe"]
    Hq, Hkv, Dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    return {"M": D * (d_inner + d_xbc + H) + d_inner * D,
            "E": D * m["num_experts"] + m["top_k"] * 2 * D * m["d_expert"]
            + 2 * D * m["d_shared"],
            "*": D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D}


def k7(cfg: dict, batch: int, seq: int) -> dict:
    """K7: one layer's SSD scan: x, and B and C once a group, in bf16, dt
    and A in f32 read; y and the final state written in f32."""
    H, P, G, N, _, _, _ = _ssm(cfg)
    tokens = batch * seq
    nbytes = (tokens * H * P * BF16 + tokens * H * F32 + H * F32
              + 2 * tokens * G * N * BF16 + tokens * H * P * F32
              + batch * H * P * N * F32)
    return {"flops": 5 * P * N * H * tokens, "bytes": nbytes,
            "precision": "f32"}


def expert_mm(cfg: dict, batch: int, seq: int) -> dict:
    """One layer's routed expert products: each picked row through up
    and down, the rows gathered and the outputs written in bf16, each
    expert's weights read once."""
    m = cfg["moe"]
    D, F_, E = cfg["d_model"], m["d_expert"], m["num_experts"]
    rows = batch * seq * m["top_k"]
    return {"flops": 2 * rows * 2 * D * F_,
            "bytes": (2 * rows * (D + F_) + 2 * E * D * F_) * BF16,
            "precision": "bf16"}


def _times(work: dict, n: int) -> dict:
    return {"flops": n * work["flops"], "bytes": n * work["bytes"],
            "precision": work["precision"]}


def prefill(cfg: dict, batch: int, prompt: int) -> dict:
    """The counts of a prefill of ``batch`` prompts of ``prompt`` tokens:
    the forward, the last position's logits, the caches it fills."""
    n = _layers(cfg)
    macs = layer_macs(cfg)
    D, V = cfg["d_model"], cfg["vocab"]
    tokens = batch * prompt
    H, P, G, N, d_inner, d_xbc, K = _ssm(cfg)
    Hq, Hkv, Dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    scan = k7(cfg, batch, prompt)
    flops = (2 * tokens * sum(n[k] * macs[k] for k in macs)
             + n["M"] * (scan["flops"] + 2 * K * d_xbc * tokens)
             + n["*"] * 4 * Dh * Hq * batch * attention_pairs(prompt, 0)
             + 2 * batch * D * V)
    m = cfg["moe"]
    # every weight once (each expert's, not only k a token's), the output
    # matrix and the embedding rows the tokens gather
    weights = (sum(n[k] * macs[k] for k in macs)
               + n["E"] * (m["num_experts"] - m["top_k"]) * 2 * D
               * m["d_expert"] + D * V + tokens * D)
    caches = (n["*"] * tokens * 2 * Hkv * Dh * BF16
              + n["M"] * batch * (H * P * N * F32 + (K - 1) * d_xbc * BF16))
    nbytes = (weights * BF16 + caches + tokens * TOKEN + batch * V * BF16)
    return {"prefill": {"flops": flops, "bytes": nbytes, "precision": "bf16"},
            "expert_mm": _times(expert_mm(cfg, batch, prompt), n["E"]),
            "k7": _times(scan, n["M"])}
