"""Training and aggregation steps, one silo and silo-stacked (port of
``repro.training.steps``).

``make_train_step``: the reference's ``jax.value_and_grad`` becomes
``torch.autograd.grad`` of ``model.loss_fn`` with respect to the fp32
master leaves; the optimizer update follows under ``no_grad``. Like the
reference the step is functional: it returns new params and optimizer
state.

Multi-pod FL: every leaf gains a leading ``(n_pods,)`` silo dim. The
reference ``vmap``s the one-silo step over it; here the step runs once
per silo on that silo's slice and the results are stacked again
(``torch.func.vmap`` does not compose with ``torch.autograd.grad`` on
leaves), so silo i's result is bitwise the one-silo step on silo i. The
FedAvg over the silo dim (the paper's Model Aggregator) is plain PyTorch,
as the reference computes it outside any kernel.
"""
from __future__ import annotations

import torch

from repro_torch import tree as _tree
from repro_torch.optim.adamw import apply_updates


def make_train_step(model, opt):
    """(params, opt_state, batch) -> (params, opt_state, metrics), on the
    model's device (``build_model`` chose it)."""
    def train_step(params, opt_state, batch):
        flat, treedef = _tree.flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss, metrics = model.loss_fn(_tree.unflatten(treedef, leaves),
                                      batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            params = _tree.unflatten(treedef, [p.detach() for p in leaves])
            grads = _tree.unflatten(treedef, list(grads))
            updates, opt_state, opt_info = opt.update(grads, opt_state,
                                                      params)
            params = apply_updates(params, updates)
        metrics = {**{k: v.detach() for k, v in metrics.items()},
                   **opt_info, "loss": loss.detach()}
        return params, opt_state, metrics

    return train_step


def silo(tree, i: int):
    """Silo ``i`` of a silo-stacked tree: each tensor leaf's slice ``i``
    as a fresh contiguous tensor; other leaves (the optimizer's step
    count, which every silo shares) as they are."""
    return _tree.tree_map(
        lambda a: a[i].clone() if isinstance(a, torch.Tensor) else a, tree)


def stack_silos(trees):
    """Same-structure trees stacked leaf by leaf on a new silo dim; a
    non-tensor leaf (a count or rate) must agree across silos and stays
    as it is."""
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        if any(x != xs[0] for x in xs[1:]):
            raise ValueError(f"silos disagree on a shared leaf: {xs}")
        return xs[0]
    return _tree.tree_map(stack, *trees)


def make_multipod_train_step(model, opt, n_pods: int):
    """The one-silo step over the leading silo dim of params, optimizer
    state and batch; metrics come back as (n_pods,) tensors."""
    step = make_train_step(model, opt)

    def multipod_step(params, opt_state, batch):
        outs = [step(silo(params, i), silo(opt_state, i), silo(batch, i))
                for i in range(n_pods)]
        return tuple(stack_silos([o[k] for o in outs]) for k in range(3))

    return multipod_step


def fedavg_pod_params(stacked_params, weights=None):
    """Model Aggregator data plane: the f32 mean over the silo dim (or
    the normalised ``weights``' tensordot), broadcast back to every silo
    so training continues from the aggregate."""
    def agg(leaf):
        lf = leaf.to(torch.float32)
        if weights is None:
            m = torch.mean(lf, dim=0, keepdim=True)
        else:
            w = torch.as_tensor(weights, dtype=torch.float32,
                                device=leaf.device)
            w = w / torch.sum(w)
            m = torch.tensordot(w, lf, dims=([0], [0]))[None]
        return m.expand(leaf.shape).to(leaf.dtype).contiguous()

    return _tree.tree_map(agg, stacked_params)


def make_fedavg_pod_step(quantize: bool = False):
    """The cross-silo aggregation step. ``quantize=True`` is the
    reference's int8 variant: each silo's leaf quantized to symmetric int8
    with one scale ``max|x|/127 + 1e-12`` (round half to even, clipped to
    +-127), dequantized, then the f32 mean."""
    if not quantize:
        return fedavg_pod_params

    def quantized_fedavg(stacked_params, weights=None):
        def agg(leaf):
            lf = leaf.to(torch.float32)
            dims = tuple(range(1, lf.dim()))
            amax = torch.amax(torch.abs(lf), dim=dims, keepdim=True) \
                if dims else torch.abs(lf)
            # true divisions by tensors on the leaf's device: a division
            # by a host scalar may run as a multiply by its reciprocal
            scale = amax / torch.full_like(amax, 127.0) + 1e-12
            q = torch.clamp(torch.round(lf / scale), -127, 127).to(
                torch.int8)
            deq = q.to(torch.float32) * scale
            m = torch.mean(deq, dim=0, keepdim=True)
            return m.expand(leaf.shape).to(leaf.dtype).contiguous()

        return _tree.tree_map(agg, stacked_params)

    return quantized_fedavg
