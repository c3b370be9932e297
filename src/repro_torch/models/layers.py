"""Shared neural-net building blocks (port of ``repro.models.layers``).

Params are plain nested dicts of tensors, stored fp32 (master) and cast at
use site by the model wrapper. Initializers draw from an explicit
``torch.Generator`` on the target device: the same distributions as the
reference's ``jax.random`` draws, not the same numbers.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
import torch.nn.functional as F

from repro_torch.sharding.mesh import program_scope
from repro_torch.sharding.serve import batch_only
from repro_torch.sharding.specs import contiguous_stride


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               scale: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal ([-2, 2]) fan-in init for all projections."""
    std = scale / (shape[in_axis] ** 0.5)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in f32, scaled by ``(1 + weight)``."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # theta stays a host scalar, which the kernel takes as an argument: a
    # copy of it onto the card would wait for the host, and a captured
    # decode step (``models/decode_graph.py``) cannot wait
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].to(torch.float32) * inv         # (..., S, D/2)
    sin = torch.sin(ang)[..., None, :]                         # (..., S, 1, D/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             use_bias: bool = False) -> dict:
    """SwiGLU weights, and zero biases when ``use_bias``."""
    p = {
        "w_gate": dense_init(gen, (d_model, d_ff)),
        "w_up": dense_init(gen, (d_model, d_ff)),
        "w_down": dense_init(gen, (d_ff, d_model)),
    }
    if use_bias:
        dev = gen.device
        p["b_gate"] = torch.zeros(d_ff, dtype=torch.float32, device=dev)
        p["b_up"] = torch.zeros(d_ff, dtype=torch.float32, device=dev)
        p["b_down"] = torch.zeros(d_model, dtype=torch.float32, device=dev)
    return p


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    gate = x @ p["w_gate"].to(dtype)
    up = x @ p["w_up"].to(dtype)
    if "b_gate" in p:
        gate = gate + p["b_gate"].to(dtype)
        up = up + p["b_up"].to(dtype)
    out = (F.silu(gate) * up) @ p["w_down"].to(dtype)
    if "b_down" in p:
        out = out + p["b_down"].to(dtype)
    return out


def checkpointed(fn, *args):
    """``fn(*args)``; while autograd records, under ``torch.utils.checkpoint``
    (the reference's ``jax.checkpoint``): the activations inside ``fn`` are
    not kept for the backward, which runs ``fn`` again. Over ranks the
    recompute re-enters the forward's mesh scope (``program_scope``)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    scope = program_scope()
    body = fn
    if scope is not None:
        def body(*a):
            with scope():
                return fn(*a)
    return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last dim. Over ranks (a DTensor whose vocab
    dim may be sharded) it is vocab-parallel (``_VocabLogsumexp``), so no
    rank gathers the logits or their gradient."""
    if not isinstance(logits, DTensor):
        return torch.logsumexp(logits, dim=-1)
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if p.is_partial() else p for p in logits.placements])
    return _VocabLogsumexp.apply(logits)


class _VocabLogsumexp(torch.autograd.Function):
    """The vocab-parallel logsumexp of a ``DTensor`` over its last dim:
    each rank's max and sum of exp over its vocab shard, all-reduced (max,
    then sum) over the mesh dims that split the vocab, as the reference's
    vocab-parallel CE. The gradient, softmax times the incoming one, is
    computed on each rank's shard and keeps the logits' placement."""

    @staticmethod
    def forward(ctx, logits):
        mesh, pl = logits.device_mesh, list(logits.placements)
        last = logits.dim() - 1
        vocab = [i for i, p in enumerate(pl)
                 if isinstance(p, Shard) and p.dim == last]
        x = logits.to_local()
        m = torch.amax(x, dim=-1, keepdim=True)
        for i in vocab:
            dist.all_reduce(m, dist.ReduceOp.MAX, group=mesh.get_group(i))
        s = torch.sum(torch.exp(x - m), dim=-1)
        for i in vocab:
            dist.all_reduce(s, group=mesh.get_group(i))
        lse = torch.log(s) + m[..., 0]
        out_pl = [Replicate() if i in vocab else p for i, p in enumerate(pl)]
        ctx.save_for_backward(x, lse)
        ctx.spec = (mesh, pl, out_pl, logits.shape, logits.stride())
        shape = logits.shape[:-1]
        return DTensor.from_local(lse, mesh, out_pl, run_check=False,
                                  shape=shape,
                                  stride=contiguous_stride(shape))

    @staticmethod
    def backward(ctx, grad):
        x, lse = ctx.saved_tensors
        mesh, pl, out_pl, shape, stride = ctx.spec
        g = grad.redistribute(mesh, out_pl).to_local()
        gx = g[..., None] * torch.exp(x - lse[..., None])
        return DTensor.from_local(gx, mesh, pl, run_check=False, shape=shape,
                                  stride=stride)


def _gold_logits(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``logits[..., y]``. Over ranks (a DTensor whose vocab dim may be
    sharded) it is the masked sum over the vocab, so each rank sums its
    own columns and only the (B, S) partials are all-reduced, as the
    reference's vocab-parallel CE; the other terms are exact zeros."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, y[..., None])[..., 0]
    mesh, last = logits.device_mesh, logits.dim() - 1
    # the ids split as the logits' vocab, the labels as their rows, so
    # the mask is no larger than a rank's logits
    ids = distribute_tensor(
        torch.arange(logits.shape[-1], device=logits.device), mesh,
        [Shard(0) if isinstance(p, Shard) and p.dim == last else Replicate()
         for p in logits.placements], src_data_rank=None)
    rows = [p if isinstance(p, Shard) and p.dim < last else Replicate()
            for p in logits.placements]
    y = (y.redistribute(mesh, rows) if isinstance(y, DTensor) else
         distribute_tensor(y, mesh, rows, src_data_rank=None))
    hit = ids == y[..., None]
    return torch.sum(torch.where(hit, logits, 0.0), dim=-1)


def _vocab_only(w):
    """A ``DTensor`` unembed (D, V) kept split by vocab only: its d_model
    dim gathered where FSDP splits it. A plain tensor as it is."""
    if not isinstance(w, DTensor):
        return w
    pl = [p if isinstance(p, Shard) and p.dim == 1 else Replicate()
          for p in w.placements]
    return w if pl == list(w.placements) else w.redistribute(
        w.device_mesh, pl)


def chunked_softmax_xent(hidden: torch.Tensor, unembed: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor, *,
                         chunk: int = 512,
                         final_softcap: float = 0.0) -> torch.Tensor:
    """Mean next-token CE. hidden: (B,S,D); unembed: (D,V); labels: (B,S).

    Logits are computed chunk by chunk over the sequence, so the peak
    logits buffer is (B, chunk, V); each chunk is checkpointed, as the
    reference's, so the backward keeps no chunk's logits either. The logsumexp runs over all ``unembed`` columns,
    padded vocab ids included, as the reference's. Over ranks each hidden
    chunk is whole but for its batch (``serve.batch_only``) and the
    unembed split by vocab only (``_vocab_only``), so the logits come out
    split by vocab and never partial: a partial (B, chunk, V) would cost
    an all-reduce of the logits a chunk.
    """
    S = hidden.shape[1]
    chunk = min(chunk, S)
    w = _vocab_only(unembed.to(hidden.dtype))

    def chunk_loss(h, y, m):
        h = batch_only(h)
        logits = softcap((h @ w).to(torch.float32), final_softcap)
        logz = _logsumexp(logits)
        gold = _gold_logits(logits, y)
        return torch.sum((logz - gold) * m), torch.sum(m)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        part, n = checkpointed(chunk_loss, hidden[:, s0:s0 + chunk],
                               labels[:, s0:s0 + chunk],
                               mask[:, s0:s0 + chunk])
        tot = tot + part
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)
