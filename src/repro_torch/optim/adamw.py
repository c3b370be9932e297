"""Inner (per-silo) optimizers: AdamW and SGD over trees of tensors
(port of ``repro.optim.adamw``).

Functional like the reference: ``update`` returns new updates and state
and leaves its inputs alone. ``cosine_schedule`` gives an ``lr`` callable
for either optimizer. Global-norm clipping comes before the
moments; moments are fp32 whatever the compute dtype; ``count`` is a
Python int. Over ranks each gradient is first placed as its moment
(``_placed_as``), so the update gathers nothing.

What changes from step to step (the learning rate, AdamW's bias
corrections ``1 - b ** count``) the host computes in f64 for each step
(``Optimizer.scalars``), and the update reads as 0-d f32 tensors on the
gradients' device (``on_device``): a captured step (``training/
train_graph.py``) refills them before each replay, and an eager step
divides and multiplies by the same tensors, so the two agree bitwise.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree as _tree


class Optimizer(NamedTuple):
    init: Callable
    # (grads, state, params, scalars=None) -> (updates, state, info);
    # ``scalars``: ``scalars(count)``'s values as 0-d f32 tensors on the
    # gradients' device, made by the update itself when None
    update: Callable
    # count -> {name: float}, the host values of step ``count``
    scalars: Callable


def on_device(values: Dict[str, float], like) -> Dict[str, torch.Tensor]:
    """Host ``values`` as 0-d f32 tensors on ``like``'s device, each
    filled from its double (one rounding to f32, no copy from the host)."""
    return {k: torch.full((), v, dtype=torch.float32, device=like.device)
            for k, v in values.items()}


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine decay to
    ``floor * peak_lr`` at ``total``, evaluated in f32 as the reference
    does. A tensor step gives a tensor lr on its device; an int or float
    step gives a float."""
    def lr(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        out = torch.where(s < warmup, warm, cos)
        return out if isinstance(step, torch.Tensor) else float(out)
    return lr


def clip_by_global_norm(grads, max_norm: float):
    leaves = _tree.leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return _tree.tree_map(lambda g: g * scale, grads), gn


def _placed_as(g, like):
    """A ``DTensor`` gradient redistributed to the placement of ``like``
    (its moment, placed as its parameter): a partial gradient is
    reduce-scattered, a replicated one keeps its shard. Plain tensors as
    they are."""
    if (isinstance(g, DTensor) and isinstance(like, DTensor)
            and tuple(g.placements) != tuple(like.placements)):
        return g.redistribute(like.device_mesh, like.placements)
    return g


def _f32_zeros(p):
    # zeros_like keeps a DTensor's placement: the moments are sharded as
    # their parameter is
    return torch.zeros_like(p, dtype=torch.float32)


def adamw(lr, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, max_grad_norm: float = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"m": _tree.tree_map(_f32_zeros, params),
                "v": _tree.tree_map(_f32_zeros, params), "count": 0}

    def host_values(count):
        return {"lr": float(lr_fn(count)), "c1": 1 - b1 ** count,
                "c2": 1 - b2 ** count}

    def update(grads, state, params, scalars=None):
        grads = _tree.tree_map(_placed_as, grads, state["m"])
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        count = state["count"] + 1
        if scalars is None:
            scalars = on_device(host_values(count), _tree.leaves(grads)[0])
        m = _tree.tree_map(lambda m_, g: b1 * m_ + (1 - b1)
                           * g.to(torch.float32), state["m"], grads)
        v = _tree.tree_map(lambda v_, g: b2 * v_ + (1 - b2)
                           * torch.square(g.to(torch.float32)),
                           state["v"], grads)
        c1, c2, step_lr = scalars["c1"], scalars["c2"], scalars["lr"]
        neg_lr = -step_lr
        updates = _tree.tree_map(
            lambda m_, v_, p: neg_lr * ((m_ / c1) / (torch.sqrt(v_ / c2)
                                                     + eps)
                                        + weight_decay
                                        * p.to(torch.float32)),
            m, v, params)
        return (updates, {"m": m, "v": v, "count": count},
                {"grad_norm": gnorm, "lr": step_lr})

    return Optimizer(init, update, host_values)


def sgd(lr, *, momentum: float = 0.0, max_grad_norm: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        st = {"count": 0}
        if momentum:
            st["mu"] = _tree.tree_map(_f32_zeros, params)
        return st

    def host_values(count):
        return {"lr": float(lr_fn(count))}

    def update(grads, state, params, scalars=None):
        gnorm = torch.zeros(())
        if max_grad_norm:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        count = state["count"] + 1
        if scalars is None:
            scalars = on_device(host_values(count), _tree.leaves(grads)[0])
        step_lr = scalars["lr"]
        neg_lr = -step_lr
        new_state = {"count": count}
        if momentum:
            grads = new_state["mu"] = _tree.tree_map(
                lambda mu_, g: momentum * mu_ + g.to(torch.float32),
                state["mu"], grads)
        updates = _tree.tree_map(lambda g: neg_lr * g.to(torch.float32),
                                 grads)
        return updates, new_state, {"grad_norm": gnorm, "lr": step_lr}

    return Optimizer(init, update, host_values)


def apply_updates(params, updates):
    return _tree.tree_map(
        lambda p, u: (p.to(torch.float32) + u).to(p.dtype), params, updates)
