"""Single-silo training step (port of
``repro.training.steps.make_train_step``).

The reference's ``jax.value_and_grad`` becomes ``torch.autograd.grad`` of
``model.loss_fn`` with respect to the fp32 master leaves; the optimizer
update follows under ``no_grad``. Like the reference the step is
functional: it returns new params and optimizer state.
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
