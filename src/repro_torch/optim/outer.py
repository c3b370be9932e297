"""Server-side ("outer") optimizers for federated rounds — FedOpt family
(port of ``repro.optim.outer``).

The server treats (global - aggregated) as a pseudo-gradient. FedAvg is
the identity outer step; FedAvgM adds server momentum; FedAdam is
adaptive. [Reddi et al., Adaptive Federated Optimization]
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import tree as _tree


class OuterOptimizer(NamedTuple):
    name: str
    init: Callable
    step: Callable   # (global_params, aggregated, state) -> (params, state)


def _f32(a):
    return a.to(torch.float32)


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _spanned(name: str, init: Callable, step: Callable) -> OuterOptimizer:
    """The optimizer with its ``step`` under an ``outer.step`` span on
    the aggregate's device."""
    def spanned_step(global_params, aggregated, state):
        leaves = _tree.leaves(aggregated)
        dev = leaves[0].device if leaves and isinstance(
            leaves[0], torch.Tensor) else None
        # repro_torch.core imports this module: import its telemetry late
        from repro_torch.core.telemetry import current
        with current().span("outer.step", cat="outer", device=dev):
            return step(global_params, aggregated, state)

    return OuterOptimizer(name, init, spanned_step)


def fedavg() -> OuterOptimizer:
    def init(params):
        return {}

    def step(global_params, aggregated, state):
        return aggregated, state

    return _spanned("fedavg", init, step)


def fedavgm(server_lr: float = 1.0, momentum: float = 0.9) -> OuterOptimizer:
    def init(params):
        return {"mu": _tree.tree_map(_zeros, params)}

    def step(global_params, aggregated, state):
        mu = _tree.tree_map(lambda m, g, a: momentum * m + (_f32(g) - _f32(a)),
                            state["mu"], global_params, aggregated)
        new = _tree.tree_map(lambda g, m: (_f32(g) - server_lr * m).to(g.dtype),
                             global_params, mu)
        return new, {"mu": mu}

    return _spanned("fedavgm", init, step)


def fedadam(server_lr: float = 1e-2, b1: float = 0.9, b2: float = 0.99,
            eps: float = 1e-3) -> OuterOptimizer:
    def init(params):
        return {"m": _tree.tree_map(_zeros, params),
                "v": _tree.tree_map(_zeros, params), "count": 0}

    def step(global_params, aggregated, state):
        delta = _tree.tree_map(lambda a, g: _f32(a) - _f32(g),
                               aggregated, global_params)   # ascent direction
        m = _tree.tree_map(lambda m_, d: b1 * m_ + (1 - b1) * d,
                           state["m"], delta)
        v = _tree.tree_map(lambda v_, d: b2 * v_ + (1 - b2) * torch.square(d),
                           state["v"], delta)
        new = _tree.tree_map(
            lambda g, m_, v_: (_f32(g) + server_lr * m_ / (torch.sqrt(v_) + eps))
            .to(g.dtype), global_params, m, v)
        return new, {"m": m, "v": v, "count": state["count"] + 1}

    return _spanned("fedadam", init, step)


OUTER_REGISTRY = {
    "fedavg": fedavg,
    "fedavgm": fedavgm,
    "fedadam": fedadam,
}
