"""Client contribution measurement (paper §V Evaluation Coordinator:
"responsible for measuring the client contribution" — compensation fairness
is a §III requirement).

Port of ``repro.core.contribution``; the update norms run in float64 on
the base params' device, over trees of tensors or arrays.

Three measures, cheapest to priciest:
  * data_size   — examples contributed (FedAvg weighting baseline)
  * update_norm — gradient-energy proxy
  * loo_eval    — leave-one-out: marginal effect of each client's update on
                  the cohort-mean eval loss (gold standard, needs an eval fn)
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.core.aggregation import fedavg
from repro_torch.device import DEFAULT_DEVICE


def _f64(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.float64))
    return x.to(device, torch.float64)


def data_size_contribution(sizes: Dict[str, int]) -> Dict[str, float]:
    total = sum(sizes.values()) or 1
    return {cid: s / total for cid, s in sizes.items()}


def update_norm_contribution(updates: Dict[str, dict], base,
                             weights: Optional[Dict[str, float]] = None
                             ) -> Dict[str, float]:
    """Gradient-energy shares. Under weighted FedAvg the aggregate commits
    ``w_i * delta_i``, so each norm is scaled by the client's ``w_i``
    (``weights``, e.g. the round's n_examples) — an unweighted norm would
    score a counterfactual update the server never applied."""
    norms = {}
    for cid, upd in updates.items():
        if isinstance(upd, dict) and "scheme" in upd:
            # compressed wire dict, not a parameter tree: delegate to the
            # compression layer's norm (which refuses masked_int8 loudly)
            from repro_torch.core.compression import update_norm
            norms[cid] = update_norm(upd)
        else:
            sq = 0.0
            for u, b in zip(_tree.leaves(upd), _tree.leaves(base)):
                dev = b.device if isinstance(b, torch.Tensor) else "cpu"
                d = _f64(u, dev) - _f64(b, dev)
                sq += float((d * d).sum())
            norms[cid] = sq ** 0.5
        if weights is not None:
            norms[cid] *= float(weights[cid])
    total = sum(norms.values()) or 1.0
    return {cid: n / total for cid, n in norms.items()}


def leave_one_out_contribution(updates: Dict[str, dict],
                               eval_fn: Callable[[dict], float],
                               weights: Optional[Dict[str, float]] = None,
                               *, device=DEFAULT_DEVICE
                               ) -> Dict[str, float]:
    """contribution_i = loss(without i) - loss(with all); positive = helpful.

    ``weights`` (n_examples under weighted FedAvg) make every
    re-aggregation — full cohort and each leave-one-out counterfactual —
    use the same weighting the server actually committed. The
    re-aggregations run on ``device``.
    """
    cids = sorted(updates)

    def agg(members):
        ups = [updates[c] for c in members]
        w = [weights[c] for c in members] if weights is not None else None
        return fedavg(ups, w, device=device)

    full_loss = eval_fn(agg(cids))
    out = {}
    for cid in cids:
        rest = [c for c in cids if c != cid]
        if not rest:
            out[cid] = 0.0
            continue
        loo_loss = eval_fn(agg(rest))
        out[cid] = float(loo_loss - full_loss)
    return out


CONTRIBUTION_MEASURES = ("data_size", "update_norm", "loo_eval")
