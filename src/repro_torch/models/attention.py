"""Attention: GQA (covers MHA) with optional biases and qk-norm,
sliding window, logit softcap, cross-attention (enc-dec) and MLA, with
ring-buffer caches (port of ``repro.models.attention``).

Two execution paths for the softmax-attention core of a full sequence:
  * ``impl="xla"``    — plain masked matmul + softmax, written out: scores
    are f32 even for bf16 q and k (the reference's
    ``preferred_element_type=jnp.float32``), masked entries are
    ``NEG_INF``, q is processed in chunks of ``Q_CHUNK`` rows
  * ``impl="kernel"`` — K6 flash attention (``kernels/flash_attention``),
    the counterpart of the reference's ``impl="pallas"``: the GQA prefill
    hot path. The window is a Python int per layer.
Decode, cross-attention and MLA always take the plain path, as in the
reference (MLA's q/k head dim, 96, differs from its v head dim, 64).

Over a mesh of ranks a serve program's full-sequence attention (a
prefill, an enc-dec's encoder) runs head-parallel on local tensors
(``_gqa_over_ranks``, ``_mla_over_ranks``; ``sharding/serve.py``).

KV caches are ring buffers carrying their own position array. The port
writes them in place (``cache_write``), where the reference returns new
arrays: a decode step then copies no cache. A write of more positions
than the ring holds keeps each row's last ``T`` (the reference's CPU
scatter keeps the last of colliding writes; CUDA's does not promise
which).
"""
from __future__ import annotations

import os

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch import tree as _tree

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import (apply_rope, checkpointed,
                                       dense_init, rms_norm, softcap)
from repro_torch.sharding import serve as _serve
from repro_torch.sharding.specs import (P, cache_full, constrain,
                                        replicated_call)

NEG_INF = -2.3819763e38  # most-negative bf16-representable
Q_CHUNK = 512
IMPLS = ("xla", "kernel")


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,D), k: (B,Sk,Hkv,D) -> f32 scores (B,Hkv,G,Sq,Sk).

    Inputs are widened to f32 first: the products of bf16 values are
    exact in f32, so this is the reference's bf16 x bf16 -> f32 einsum.
    """
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D).to(torch.float32)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))


def make_attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        k_valid: torch.Tensor, *, causal: bool,
                        window: int) -> torch.Tensor:
    """Boolean mask (B,1,1,Sq,Sk). ``window`` <= 0 means global; a
    windowed layer attends to k_pos in (q_pos - window, q_pos]."""
    qp = q_pos[:, :, None]
    kp = k_pos[:, None, :]
    m = k_valid[:, None, :]
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    return m[:, None, None, :, :]


def _attend_block(q, k, v, mask, *, logit_softcap: float, scale: float):
    """One q-block of masked softmax attention (scores materialized)."""
    B, Sq, H, _ = q.shape
    Dv = v.shape[-1]
    scores = _grouped_scores(q, k) * scale            # (B,Hkv,G,Sq,Sk) f32
    if os.environ.get("REPRO_TREE_DECODE") == "1" and Sq == 1:
        # tree_decode variant: the scores stay sharded on the KV-sequence
        # dim over "data" (the mesh in scope; none: the identity), so the
        # softmax reduces (B, H) partials instead of gathering the cache
        scores = constrain(scores, P(None, None, None, None, "data"))
    scores = softcap(scores, logit_softcap)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, Dv)


def attend_masked(q, k, v, *, q_pos, k_pos, k_valid, causal: bool,
                  window: int, logit_softcap: float = 0.0, scale: float,
                  q_chunk: int = Q_CHUNK):
    """Masked attention in q-chunks: the peak scores buffer is
    (B, H, q_chunk, Sk). A sequence that is not a whole number of chunks
    runs as one block, as in the reference. Each chunk is checkpointed,
    as the reference's, so the backward keeps no chunk's scores either."""
    Sq = q.shape[1]

    def block(q_blk, qp_blk):
        mask = make_attention_mask(qp_blk, k_pos, k_valid, causal=causal,
                                   window=window)
        return _attend_block(q_blk, k, v, mask,
                             logit_softcap=logit_softcap, scale=scale)

    if Sq <= q_chunk or Sq % q_chunk != 0:
        return block(q, q_pos)
    return torch.cat([checkpointed(block, q[:, s:s + q_chunk],
                                   q_pos[:, s:s + q_chunk])
                      for s in range(0, Sq, q_chunk)], dim=1)


def attend(q, k, v, mask, *, logit_softcap: float = 0.0, scale: float):
    """Single-block path (decode, small sequences, tests)."""
    return _attend_block(q, k, v, mask, logit_softcap=logit_softcap,
                         scale=scale)


def gqa_init(gen: torch.Generator, cfg) -> dict:
    D, H, Hkv, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    p = {
        "wq": dense_init(gen, (D, H * Dh)),
        "wk": dense_init(gen, (D, Hkv * Dh)),
        "wv": dense_init(gen, (D, Hkv * Dh)),
        "wo": dense_init(gen, (H * Dh, D)),
    }

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=gen.device)

    if cfg.use_bias:
        p["bq"], p["bk"] = zeros(H * Dh), zeros(Hkv * Dh)
        p["bv"], p["bo"] = zeros(Hkv * Dh), zeros(D)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = zeros(Dh), zeros(Dh)
    return p


def gqa_project_qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Biases before the head reshape; qk-norm over the head dim after it
    and before RoPE, as the reference (no RoPE where ``cfg.rotary`` is
    False)."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q, k, v = (q + p["bq"].to(dt), k + p["bk"].to(dt),
                   v + p["bv"].to(dt))
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.has_rotary:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_out(p: dict, out: torch.Tensor) -> torch.Tensor:
    B, S = out.shape[:2]
    y = out.reshape(B, S, -1) @ p["wo"].to(out.dtype)
    if "bo" in p:
        y = y + p["bo"].to(out.dtype)
    return y


def _self_attend(cfg, q, k, v, positions, *, window: int, causal: bool,
                 impl: str):
    """The attention core over a full sequence, by ``impl``.

    ``"kernel"`` masks causal and window by index, so it assumes
    ``positions`` is ``arange(S)`` in every row, as the model's stream
    gives; ``"xla"`` masks by ``positions`` themselves. Offset or packed
    positions need the ``"xla"`` path."""
    scale = cfg.resolved_head_dim ** -0.5
    if impl == "kernel":
        return flash_ops.flash_attention(
            q, k, v, causal=causal, window=int(window),
            logit_softcap=cfg.attn_logit_softcap, scale=scale)
    if impl != "xla":
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return attend_masked(q, k, v, q_pos=positions, k_pos=positions,
                         k_valid=torch.ones(positions.shape, dtype=torch.bool,
                                            device=positions.device),
                         causal=causal, window=int(window),
                         logit_softcap=cfg.attn_logit_softcap, scale=scale)


def gqa_self_attention(p: dict, cfg, x: torch.Tensor,
                       positions: torch.Tensor, *, window: int,
                       causal: bool = True, impl: str = "xla",
                       serve: bool = False):
    """Full-sequence self-attention (train / prefill). ``serve``: a serve
    program's, head-parallel over ranks (``_gqa_over_ranks``)."""
    if serve and _serve.over_ranks(x):
        return _gqa_over_ranks(p, cfg, x, positions, window=window,
                               causal=causal, impl=impl)[0]
    q, k, v = gqa_project_qkv(p, cfg, x, positions)
    out = _self_attend(cfg, q, k, v, positions, window=window, causal=causal,
                       impl=impl)
    return gqa_out(p, out)


def gqa_prefill(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                window: int, cache_len: int, impl: str = "xla"):
    """Full-sequence self-attention that also fills a fresh KV cache;
    head-parallel over ranks (``_gqa_over_ranks``)."""
    if _serve.over_ranks(x):
        y, k, v = _gqa_over_ranks(p, cfg, x, positions, window=window,
                                  causal=True, impl=impl)
    else:
        q, k, v = gqa_project_qkv(p, cfg, x, positions)
        y = gqa_out(p, _self_attend(cfg, q, k, v, positions, window=window,
                                    causal=True, impl=impl))
    cache = gqa_cache_init(cfg, x.shape[0], cache_len, k.dtype, x.device)
    cache = cache_write(cache, k, v, positions)
    return y, cache


def _kv_for(k: torch.Tensor, lo: int, hi: int, group: int) -> torch.Tensor:
    """The kv heads of q heads ``[lo, hi)`` (q head h reads kv head
    h // group): a slice of ``k``'s heads when the span takes whole groups
    or part of one, else one kv head a q head."""
    klo, khi = lo // group, (hi - 1) // group + 1
    n = khi - klo
    per = (hi - lo) // n
    if (hi - lo) % n == 0 and all((lo + i) // group - klo == i // per
                                  for i in range(hi - lo)):
        return k[:, :, klo:khi]
    idx = torch.tensor([(lo + i) // group for i in range(hi - lo)],
                       device=k.device)
    return k.index_select(2, idx)


def _gqa_over_ranks(p: dict, cfg, x, positions, *, window: int,
                    causal: bool, impl: str):
    """A serve program's self-attention over ranks, head-parallel over
    "model" (``sharding/serve.py``): this rank's q heads from its columns
    of ``wq``, keys and values gathered whole over "model", attention on
    plain local tensors (K6 on the card for ``impl="kernel"``), and its
    rows of ``wo``. Returns ``(y, k, v)``: ``y`` partial over "model" (the
    bias on the group's first rank), ``k`` and ``v`` (B,S,Hkv,Dh) whole
    over "model"."""
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = _serve.batch_only(x)
    xl = x.to_local()
    B, S, _ = xl.shape
    dt = xl.dtype
    lo, hi = _serve.span(H, x)
    pos = _serve.local_rows(positions, x)
    q = xl @ _serve.head_block(p["wq"], 1, H, Dh, x).to(dt)
    k = _serve.whole(x @ p["wk"].to(dt))
    v = _serve.whole(x @ p["wv"].to(dt))
    if "bq" in p:
        q = q + _serve.head_block(p["bq"], 0, H, Dh, x).to(dt)
        k = k + _serve.full(p["bk"]).to(dt)
        v = v + _serve.full(p["bv"]).to(dt)
    q = q.reshape(B, S, hi - lo, Dh)
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    if "q_norm" in p:
        q = rms_norm(q, _serve.full(p["q_norm"]), cfg.norm_eps)
        k = rms_norm(k, _serve.full(p["k_norm"]), cfg.norm_eps)
    if cfg.has_rotary:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    wo = _serve.head_block(p["wo"], 0, H, Dh, x).to(dt)
    if hi > lo:
        out = _self_attend(cfg, q, _kv_for(k, lo, hi, H // Hkv),
                           _kv_for(v, lo, hi, H // Hkv), pos, window=window,
                           causal=causal, impl=impl)
        y = out.reshape(B, S, (hi - lo) * Dh) @ wo
    else:
        y = torch.zeros((B, S, cfg.d_model), dtype=dt, device=xl.device)
    if "bo" in p:
        bo = _serve.full(p["bo"]).to(dt)
        if _serve.is_model_rank0(x):
            y = y + bo
    return (_serve.partial(y, x), _serve.replicated(k, x),
            _serve.replicated(v, x))


# --- decode with ring-buffer cache ----------------------------------------
def gqa_cache_init(cfg, batch: int, cache_len: int, dtype,
                   device) -> dict:
    """Zero keys and values, positions -1; sharded by ``cache_pspecs``
    with a mesh over ranks in scope (``cache_full``)."""
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    kw = dict(device=device, batch=batch)
    return {
        "k": cache_full((batch, cache_len, Hkv, Dh), 0, dtype=dtype, **kw),
        "v": cache_full((batch, cache_len, Hkv, Dh), 0, dtype=dtype, **kw),
        "pos": cache_full((batch, cache_len), -1, dtype=torch.int32, **kw),
    }


def _ring_write(cache: dict, positions: torch.Tensor, new: dict) -> dict:
    """Write each (B,S_new,...) tensor of ``new`` into its cache leaf at
    ring slots pos % T, and the positions, in place. Of a write longer
    than the ring only each row's last T positions: more would hit some
    slots twice. Returns ``cache``."""
    T = cache["pos"].shape[1]
    if positions.shape[1] > T:
        positions = positions[:, -T:]
        new = {key: value[:, -T:] for key, value in new.items()}
    if any(isinstance(a, DTensor) for a in
           list(cache.values()) + list(new.values())):
        return _ring_write_over_ranks(cache, positions, new)
    return _write_slots(cache, positions, new)


def _write_slots(cache: dict, positions: torch.Tensor, new: dict) -> dict:
    T = cache["pos"].shape[1]
    slots = (positions % T).long()                               # (B,S)
    b_idx = torch.arange(positions.shape[0],
                         device=positions.device)[:, None]
    for key, value in new.items():
        cache[key][b_idx, slots] = value
    cache["pos"][b_idx, slots] = positions.to(torch.int32)
    return cache


def _ring_write_over_ranks(cache: dict, positions, new: dict) -> dict:
    """``_ring_write`` of ``DTensor``s: each rank writes its own rows,
    heads and slots into its shard of each cache leaf, and nothing is
    gathered. A cache leaf keeps its placement (a fresh plain one takes
    the new values', whole on the slot dim); the new values and positions
    are redistributed to it, whole on their position dim. A leaf whose
    slot dim is sharded (``pos``, whose innermost dim is its slots, or a
    long ring over "data") holds slots [o, o + n) on this rank, and the
    rank writes the (row, slot) pairs that fall there at slot - o."""
    ref = next(v for v in list(new.values()) + list(cache.values())
               if isinstance(v, DTensor))
    mesh = ref.device_mesh

    def target(leaf, like):
        if isinstance(leaf, DTensor):
            return list(leaf.placements)
        return [p if isinstance(p, Shard) and p.dim != 1 and p.dim < leaf.dim()
                else Replicate() for p in like.placements]

    like = next((v for v in new.values() if isinstance(v, DTensor)), ref)
    T = cache["pos"].shape[1]
    for k in list(new) + ["pos"]:
        pl = target(cache[k], like)
        if not isinstance(cache[k], DTensor):
            cache[k] = distribute_tensor(cache[k], mesh, pl,
                                         src_data_rank=None)
        value = positions.to(torch.int32) if k == "pos" else new[k]
        rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in pl]
        slots = (_placed_local(positions, mesh, rows) % T).long()
        value = _placed_local(value, mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in pl])
        shape, offset = compute_local_shape_and_global_offset(
            cache[k].shape, mesh, pl)
        _write_local(cache[k].to_local(), slots, value, offset[1], shape[1],
                     T)
    return cache


def _write_local(local: torch.Tensor, slots, value, start: int, n: int,
                 T: int):
    """``local[b, slots[b, j] - start] = value[b, j]`` in place, for the
    slots in [start, start + n): a shard of n of a leaf's T slots. A row's
    slots are distinct, so no two writes collide. A decode step (S = 1)
    writes one slot a row, kept where it falls outside the shard; a
    longer write (a prefill) maps each local slot to the column that
    writes it and rewrites the shard once."""
    B, S = slots.shape
    b_idx = torch.arange(B, device=slots.device)
    if start == 0 and n == T:
        local[b_idx[:, None], slots] = value
        return
    s = slots - start
    hit = (s >= 0) & (s < n)
    if S == 1:
        s = torch.clamp(s[:, 0], 0, n - 1)
        old = local[b_idx, s]
        h = hit[:, 0].reshape((B,) + (1,) * (old.dim() - 1))
        local[b_idx, s] = torch.where(h, value[:, 0], old)
        return
    # each local slot's column (the overflow slot n takes the rest): an
    # inverse map, not the hit pairs picked by a mask, since picking
    # needs ``nonzero``, which meta tensors (the dry run) do not have
    to = torch.where(hit, s, n)
    col = torch.zeros((B, n + 1), dtype=torch.long, device=slots.device)
    col.scatter_(1, to, torch.arange(S, device=slots.device).expand(B, S))
    filled = torch.zeros((B, n + 1), dtype=torch.bool, device=slots.device)
    filled.scatter_(1, to, hit)
    tail = (1,) * (value.dim() - 2)
    got = torch.gather(value, 1, col[:, :n].reshape((B, n) + tail).expand(
        (B, n) + tuple(value.shape[2:])))
    local.copy_(torch.where(filled[:, :n].reshape((B, n) + tail), got, local))


def _placed_local(x, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``x`` (a ``DTensor``, or a plain tensor that
    every rank holds whole) under ``placements``."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements).to_local()
    return distribute_tensor(x, mesh, placements,
                             src_data_rank=None).to_local()


def put(dst: torch.Tensor, i: int, src: torch.Tensor) -> torch.Tensor:
    """``dst[i] = src`` in place; returns ``dst``. Over ranks each rank
    writes its shard: ``dst`` keeps its placement (a plain ``dst`` takes
    ``src``'s, one dim down) and ``src`` is redistributed to match."""
    if not isinstance(src, DTensor) and not isinstance(dst, DTensor):
        dst[i] = src
        return dst
    ref = src if isinstance(src, DTensor) else dst
    mesh = ref.device_mesh
    if isinstance(dst, DTensor):
        if any(isinstance(p, Shard) and p.dim == 0 for p in dst.placements):
            return replicated_call(put, dst, i, src)
        inner = [Shard(p.dim - 1) if isinstance(p, Shard) else Replicate()
                 for p in dst.placements]
    else:
        inner = [p if isinstance(p, Shard) else Replicate()
                 for p in src.placements]
        dst = distribute_tensor(dst, mesh, [
            Shard(p.dim + 1) if isinstance(p, Shard) else p for p in inner],
            src_data_rank=None)
    dst.to_local()[i] = _placed_local(src, mesh, inner)
    return dst


def layer_views(caches: dict, i: int):
    """Layer ``i`` of stacked caches as views of the stack, and a copy of
    that tree's dicts holding the same views (for ``put_back``)."""
    views = _tree.index(caches, i)
    return views, _tree.tree_map(lambda a: a, views)


def put_back(caches: dict, i: int, views: dict, orig: dict):
    """Write into layer ``i`` of the stack every leaf that a decode step
    replaced in ``views`` (over ranks, a plain leaf that the write
    distributed); otherwise the views were written in place and nothing
    is replaced."""
    for k, v in views.items():
        if isinstance(v, dict):
            put_back(caches[k], i, v, orig[k])
        elif v is not orig[k]:
            caches[k] = put(caches[k], i, v)


def cache_write(cache: dict, k_new, v_new, positions) -> dict:
    """Write S_new keys and values at ring slots pos % T, in place (of a
    write longer than the ring, each row's last T). positions: (B,S_new).
    Returns ``cache``."""
    return _ring_write(cache, positions, {"k": k_new, "v": v_new})


def gqa_decode(p: dict, cfg, x: torch.Tensor, cache: dict,
               positions: torch.Tensor, *, window: int):
    """x: (B,1,D); positions: (B,1) absolute position of the new token.
    Writes the new key and value into ``cache`` in place."""
    q, k_new, v_new = gqa_project_qkv(p, cfg, x, positions)
    cache = cache_write(cache, k_new, v_new, positions)
    k_valid = cache["pos"] >= 0
    mask = make_attention_mask(positions, cache["pos"], k_valid,
                               causal=True, window=int(window))
    out = attend(q, cache["k"], cache["v"], mask,
                 logit_softcap=cfg.attn_logit_softcap,
                 scale=cfg.resolved_head_dim ** -0.5)
    return gqa_out(p, out), cache


# --- cross-attention (enc-dec) ---------------------------------------------
def cross_attention(p: dict, cfg, x: torch.Tensor, enc_k: torch.Tensor,
                    enc_v: torch.Tensor, enc_valid: torch.Tensor):
    """x: (B,Sq,D) decoder side; enc_k/enc_v: (B,Se,Hkv,Dh). No RoPE, no
    mask but ``enc_valid``."""
    B, Sq, _ = x.shape
    Se = enc_k.shape[1]
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, Sq, H, Dh)
    if "bq" in p:
        q = q + p["bq"].to(dt).reshape(H, Dh)
    zeros_q = torch.zeros((B, Sq), dtype=torch.int32, device=x.device)
    zeros_k = torch.zeros((B, Se), dtype=torch.int32, device=x.device)
    out = attend_masked(q, enc_k, enc_v, q_pos=zeros_q, k_pos=zeros_k,
                        k_valid=enc_valid, causal=False, window=0,
                        scale=Dh ** -0.5)
    return gqa_out(p, out)


def cross_kv(p: dict, cfg, enc_out: torch.Tensor):
    B, Se, _ = enc_out.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = enc_out.dtype
    k = (enc_out @ p["wk"].to(dt)).reshape(B, Se, Hkv, Dh)
    v = (enc_out @ p["wv"].to(dt)).reshape(B, Se, Hkv, Dh)
    if "bk" in p:
        k = k + p["bk"].to(dt).reshape(Hkv, Dh)
        v = v + p["bv"].to(dt).reshape(Hkv, Dh)
    return k, v


# --- MLA: multi-head latent attention (MiniCPM3 / DeepSeek-V2) -------------
def mla_init(gen: torch.Generator, cfg) -> dict:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=gen.device)

    return {
        "w_dq": dense_init(gen, (D, m.q_lora_rank)),
        "q_norm": zeros(m.q_lora_rank),
        "w_uq": dense_init(gen, (m.q_lora_rank,
                                 H * (m.qk_nope_dim + m.qk_rope_dim))),
        # the kv down-projection also emits the shared rotary key
        "w_dkv": dense_init(gen, (D, m.kv_lora_rank + m.qk_rope_dim)),
        "kv_norm": zeros(m.kv_lora_rank),
        "w_uk": dense_init(gen, (m.kv_lora_rank, H * m.qk_nope_dim)),
        "w_uv": dense_init(gen, (m.kv_lora_rank, H * m.v_head_dim)),
        "wo": dense_init(gen, (H * m.v_head_dim, D)),
    }


def _mla_queries(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    dt = x.dtype
    q_lat = rms_norm(x @ p["w_dq"].to(dt), p["q_norm"], cfg.norm_eps)
    q = (q_lat @ p["w_uq"].to(dt)).reshape(
        B, S, H, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latents(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    m = cfg.mla
    dkv = x @ p["w_dkv"].to(x.dtype)
    c_kv = rms_norm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    # the shared single-head rotary key
    k_rope = apply_rope(dkv[:, :, None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_self_attention(p: dict, cfg, x: torch.Tensor,
                       positions: torch.Tensor, *, causal: bool = True):
    """Train/prefill path: the latents expanded to per-head K/V (the
    standard form), plain attention."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    dt = x.dtype
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)
    c_kv, k_rope = _mla_latents(p, cfg, x, positions)
    k_nope = (c_kv @ p["w_uk"].to(dt)).reshape(B, S, H, m.qk_nope_dim)
    v = (c_kv @ p["w_uv"].to(dt)).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_dim)], dim=-1)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    out = attend_masked(q, k, v, q_pos=positions, k_pos=positions,
                        k_valid=torch.ones(positions.shape, dtype=torch.bool,
                                           device=x.device),
                        causal=causal, window=0, scale=scale)
    return out.reshape(B, S, H * m.v_head_dim) @ p["wo"].to(dt)


def mla_cache_init(cfg, batch: int, cache_len: int, dtype, device) -> dict:
    m = cfg.mla
    kw = dict(device=device, batch=batch)
    return {
        "c_kv": cache_full((batch, cache_len, m.kv_lora_rank), 0,
                           dtype=dtype, **kw),
        "k_rope": cache_full((batch, cache_len, m.qk_rope_dim), 0,
                             dtype=dtype, **kw),
        "pos": cache_full((batch, cache_len), -1, dtype=torch.int32, **kw),
    }


def _mla_over_ranks(p: dict, cfg, x, positions, *, causal: bool = True):
    """A serve program's MLA self-attention over ranks, head-parallel over
    "model" as ``_gqa_over_ranks``: the q and kv latents gathered whole
    over "model", this rank's heads expanded from its columns of ``w_uq``,
    ``w_uk`` and ``w_uv``, its rows of ``wo``. Returns ``(y, c_kv,
    k_rope)``: ``y`` partial over "model", the latents whole over it."""
    m, H = cfg.mla, cfg.n_heads
    dq = m.qk_nope_dim + m.qk_rope_dim
    x = _serve.batch_only(x)
    B, S, _ = x.to_local().shape
    dt = x.dtype
    lo, hi = _serve.span(H, x)
    pos = _serve.local_rows(positions, x)
    q_lat = rms_norm(_serve.whole(x @ p["w_dq"].to(dt)),
                     _serve.full(p["q_norm"]), cfg.norm_eps)
    dkv = _serve.whole(x @ p["w_dkv"].to(dt))
    c_kv = rms_norm(dkv[..., :m.kv_lora_rank], _serve.full(p["kv_norm"]),
                    cfg.norm_eps)
    k_rope = apply_rope(dkv[:, :, None, m.kv_lora_rank:], pos,
                        cfg.rope_theta)[:, :, 0, :]
    w_uq = _serve.head_block(p["w_uq"], 1, H, dq, x).to(dt)
    w_uk = _serve.head_block(p["w_uk"], 1, H, m.qk_nope_dim, x).to(dt)
    w_uv = _serve.head_block(p["w_uv"], 1, H, m.v_head_dim, x).to(dt)
    wo = _serve.head_block(p["wo"], 0, H, m.v_head_dim, x).to(dt)
    n = hi - lo
    if n:
        q = (q_lat @ w_uq).reshape(B, S, n, dq)
        q = torch.cat([q[..., :m.qk_nope_dim], apply_rope(
            q[..., m.qk_nope_dim:], pos, cfg.rope_theta)], dim=-1)
        k_nope = (c_kv @ w_uk).reshape(B, S, n, m.qk_nope_dim)
        v = (c_kv @ w_uv).reshape(B, S, n, m.v_head_dim)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, n, m.qk_rope_dim)], dim=-1)
        out = attend_masked(q, k, v, q_pos=pos, k_pos=pos,
                            k_valid=torch.ones(pos.shape, dtype=torch.bool,
                                               device=pos.device),
                            causal=causal, window=0, scale=dq ** -0.5)
        y = out.reshape(B, S, n * m.v_head_dim) @ wo
    else:
        y = torch.zeros((B, S, cfg.d_model), dtype=dt, device=q_lat.device)
    return (_serve.partial(y, x), _serve.replicated(c_kv, x),
            _serve.replicated(k_rope, x))


def mla_prefill(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                cache_len: int):
    if _serve.over_ranks(x):
        out, c_kv, k_rope = _mla_over_ranks(p, cfg, x, positions)
    else:
        out = mla_self_attention(p, cfg, x, positions)
        c_kv, k_rope = _mla_latents(p, cfg, x, positions)
    cache = mla_cache_init(cfg, x.shape[0], cache_len, c_kv.dtype, x.device)
    return out, _ring_write(cache, positions,
                            {"c_kv": c_kv, "k_rope": k_rope})


def mla_decode(p: dict, cfg, x: torch.Tensor, cache: dict,
               positions: torch.Tensor):
    """Absorbed decode: attention runs in the compressed latent space.

    The cache holds only (kv_lora + rope) values a position, and W_uk /
    W_uv are absorbed into the query and output projections. Writes the
    new latents into ``cache`` in place."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape                       # S == 1
    dt = x.dtype
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)
    c_new, kr_new = _mla_latents(p, cfg, x, positions)
    cache = _ring_write(cache, positions, {"c_kv": c_new, "k_rope": kr_new})
    w_uk = p["w_uk"].to(dt).reshape(m.kv_lora_rank, H, m.qk_nope_dim)
    q_lat = torch.einsum("bshd,chd->bshc", q_nope, w_uk)      # (B,1,H,C)
    f32 = torch.float32
    scores = (torch.einsum("bshc,btc->bhst", q_lat.to(f32),
                           cache["c_kv"].to(f32))
              + torch.einsum("bshd,btd->bhst", q_rope.to(f32),
                             cache["k_rope"].to(f32)))
    scores = scores * ((m.qk_nope_dim + m.qk_rope_dim) ** -0.5)
    mask = (cache["pos"] >= 0) & (cache["pos"] <= positions[:, :1])
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)              # (B,H,1,T)
    out_lat = torch.einsum("bhst,btc->bshc", probs, cache["c_kv"])
    w_uv = p["w_uv"].to(dt).reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bshc,chd->bshd", out_lat, w_uv)
    return out.reshape(B, S, H * m.v_head_dim) @ p["wo"].to(dt), cache
