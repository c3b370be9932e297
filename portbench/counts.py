"""The benchmark's own counts of the work a layer or a step needs.

Counted from the configuration's sizes, whatever implements the layer:
each input byte read once and each output byte written once; attention
as 4 * head_dim FLOPs a head for each *visible* (query, key) pair, so a
window counts only its band; no recompute; a training step as three
forward passes (the forward, then the gradients of inputs and weights).
Projections count 2 FLOPs a multiply-add; norms, RoPE, softmax and other
elementwise work are not counted. The SSM scan counts its recurrence:
5 * d_head * d_state FLOPs a token and head (decay, outer product, add,
and the read-out's multiply-add).

Every count is a dict ``{"flops", "bytes", "precision"}``; the precision
names the peak a roofline divides by (``peaks.json``).
"""
from __future__ import annotations

from typing import Dict

from portbench.reference.model import head_dim, layer_window

BF16, F32, TOKEN = 2, 4, 8       # bytes of a served weight, a float, an id


def _ssm_sizes(cfg: dict):
    s = cfg["ssm"]
    d_inner = s["expand"] * cfg["d_model"]
    heads = d_inner // s["d_head"]
    return d_inner, heads, d_inner + 2 * s["d_state"], s


def attention_pairs(seq: int, window: int) -> int:
    """Visible (query, key) pairs of one causal sequence of ``seq``
    positions; ``window`` > 0 keeps keys in (q - window, q]."""
    if window <= 0 or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def keys_visible(pos: int, window: int) -> int:
    """Keys a query at stream position ``pos`` sees."""
    return pos + 1 if window <= 0 else min(pos + 1, window)


def layer_matmul_params(cfg: dict) -> int:
    """Multiply-adds a token costs in one layer's projections."""
    D, H, Hkv, Dh = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                     head_dim(cfg))
    n = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D + 3 * D * cfg["d_ff"]
    if cfg.get("block_kind") == "hybrid":
        d_inner, heads, d_xbc, _ = _ssm_sizes(cfg)
        n += cfg["d_model"] * (d_inner + d_xbc + heads) + d_inner * D
    return n


def _ssm_token_flops(cfg: dict) -> int:
    """A token's conv and scan in one layer's SSM (0 without one)."""
    if cfg.get("block_kind") != "hybrid":
        return 0
    _, heads, d_xbc, s = _ssm_sizes(cfg)
    return 2 * s["d_conv"] * d_xbc + 5 * s["d_head"] * s["d_state"] * heads


def forward_flops(cfg: dict, batch: int, seq: int, logit_rows: int,
                  vocab: int = None) -> Dict[str, int]:
    """A forward pass over ``batch`` streams of ``seq`` positions (meta
    tokens counted), with logits at ``logit_rows`` positions of each over
    ``vocab`` columns (default: the model's vocabulary)."""
    L, D, H, Dh = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], \
        head_dim(cfg)
    tokens = batch * seq
    matmul = 2 * tokens * layer_matmul_params(cfg) * L
    attn = sum(4 * Dh * H * batch * attention_pairs(seq, layer_window(cfg, i))
               for i in range(L))
    ssm = tokens * _ssm_token_flops(cfg) * L
    logits = 2 * batch * logit_rows * D * (vocab or cfg["vocab"])
    return {"matmul": matmul, "attention": attn, "ssm": ssm,
            "logits": logits, "total": matmul + attn + ssm + logits}


def train_step(cfg: dict, batch: int, seq: int) -> dict:
    """One training step at (batch, seq): three forward passes, the CE's
    logits at the ``seq - 1`` positions that have a label."""
    fwd = forward_flops(cfg, batch, seq, seq - 1)["total"]
    return {"flops": 3 * fwd, "bytes": 0, "precision": "bf16"}


def round_work(cfg: dict, silos: int, steps: int, batch: int,
               seq: int) -> dict:
    step = train_step(cfg, batch, seq)
    return {"flops": silos * steps * step["flops"], "bytes": 0,
            "precision": "bf16"}


def weight_bytes(cfg: dict, rows_gathered: int, nbytes: int = BF16) -> int:
    """Every weight read once, of the embedding table only the rows the
    tokens gather (all of it where it is also the output matrix)."""
    L, D, V = cfg["n_layers"], cfg["d_model"], cfg["vocab"]
    n = L * layer_matmul_params(cfg) + L * 2 * D + D          # norms
    if cfg.get("block_kind") == "hybrid":
        d_inner, heads, d_xbc, s = _ssm_sizes(cfg)
        n += L * (s["d_conv"] * d_xbc + d_xbc + 3 * heads + d_inner)
    n += cfg.get("n_meta_tokens", 0) * D
    n += D * V if cfg.get("tie_embeddings") else D * V + rows_gathered * D
    return n * nbytes


def _cache_entry_bytes(cfg: dict) -> int:
    """A position's keys and values in one layer, bf16."""
    return 2 * cfg["n_kv_heads"] * head_dim(cfg) * BF16


def _state_bytes(cfg: dict) -> int:
    """One stream's SSM state and conv window in one layer."""
    if cfg.get("block_kind") != "hybrid":
        return 0
    _, heads, d_xbc, s = _ssm_sizes(cfg)
    return heads * s["d_head"] * s["d_state"] * F32 \
        + (s["d_conv"] - 1) * d_xbc * BF16


def prefill(cfg: dict, batch: int, prompt: int) -> dict:
    """A prefill of ``batch`` prompts: the forward over meta tokens and
    prompt, the last position's logits, the cache it fills written."""
    seq = cfg.get("n_meta_tokens", 0) + prompt
    flops = forward_flops(cfg, batch, seq, 1)["total"]
    nbytes = (weight_bytes(cfg, batch * prompt)
              + cfg["n_layers"] * batch * (seq * _cache_entry_bytes(cfg)
                                           + _state_bytes(cfg))
              + batch * prompt * TOKEN + batch * cfg["vocab"] * BF16)
    return {"flops": flops, "bytes": nbytes, "precision": "bf16"}


def decode_step(cfg: dict, batch: int, pos: int) -> dict:
    """One decode step of ``batch`` streams, the new token at stream
    position ``pos``: the weights and every visible key and value read,
    the new ones written, the SSM state read and written, the logits."""
    L, D, H, Dh = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], \
        head_dim(cfg)
    keys = [keys_visible(pos, layer_window(cfg, i)) for i in range(L)]
    flops = (2 * batch * layer_matmul_params(cfg) * L
             + sum(4 * Dh * H * batch * k for k in keys)
             + batch * _ssm_token_flops(cfg) * L
             + 2 * batch * D * cfg["vocab"])
    nbytes = (weight_bytes(cfg, batch)
              + batch * _cache_entry_bytes(cfg) * (sum(keys) + L)
              + 2 * L * batch * _state_bytes(cfg)
              + batch * TOKEN + batch * cfg["vocab"] * BF16)
    return {"flops": flops, "bytes": nbytes, "precision": "bf16"}


def decode_steps(cfg: dict, batch: int, first_pos: int, steps: int) -> dict:
    """The mean of ``decode_step`` over positions first_pos .. +steps-1."""
    each = [decode_step(cfg, batch, first_pos + i) for i in range(steps)]
    return {"flops": sum(e["flops"] for e in each) / steps,
            "bytes": sum(e["bytes"] for e in each) / steps,
            "precision": "bf16"}


def k1(rows: int, t: int) -> dict:
    """K1: ``rows`` f32 buffers of ``t`` folded into one with a weight
    each."""
    return {"flops": 2 * rows * t, "bytes": (rows + 1) * t * F32 + rows * F32,
            "precision": "f32"}


def k6(cfg: dict, batch: int, seq: int, window: int) -> dict:
    """K6: one layer's attention core over ``seq`` positions, bf16 q, k, v
    in and the output out."""
    H, Hkv, Dh = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    return {"flops": 4 * Dh * H * batch * attention_pairs(seq, window),
            "bytes": batch * seq * Dh * (2 * H + 2 * Hkv) * BF16,
            "precision": "bf16"}


def k7(cfg: dict, batch: int, seq: int) -> dict:
    """K7: one layer's SSD scan: x, B, C in bf16 and dt, A in f32 read;
    y and the final state written in f32."""
    _, heads, _, s = _ssm_sizes(cfg)
    P, N = s["d_head"], s["d_state"]
    tokens = batch * seq
    nbytes = (tokens * heads * P * BF16 + tokens * heads * F32 + heads * F32
              + 2 * tokens * N * BF16 + tokens * heads * P * F32
              + batch * heads * P * N * F32)
    return {"flops": 5 * P * N * heads * tokens, "bytes": nbytes,
            "precision": "f32"}
