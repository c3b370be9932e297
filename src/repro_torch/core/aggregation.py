"""Model Aggregator strategies (FedAvg and the robust options).

Port of ``repro.core.aggregation``. Two planes:

* pytree plane — lists of client parameter trees (dicts of tensors or
  arrays); leaves are stacked on ``device`` and reduced leaf by leaf.
* packed plane — an (N, T) fp32 matrix of flattened client updates;
  ``aggregate_packed`` reduces the cohort in one pass (FedAvg through K1,
  ``masked_sum``) and unpacks once if given a layout.

``median`` follows ``jnp.median``: for an even cohort it is the mean of
the two middle values (``torch.median`` would return the lower one).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch import tree as _tree
from repro_torch.core.packing import PackedLayout, as_f32, as_matrix, \
    unpack_pytree
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.kernels.secure_agg.ops import masked_sum


def _stack(updates: Sequence, device):
    return _tree.tree_map(lambda *xs: torch.stack(
        [as_f32(x, device) for x in xs]), *updates)


def _weights(weights, n: int, device) -> torch.Tensor:
    w = (torch.full((n,), 1.0 / n, dtype=torch.float32) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32))
    w = w.to(device)
    return w / w.sum()


def fedavg(updates: Sequence, weights: Optional[Sequence[float]] = None, *,
           device=DEFAULT_DEVICE):
    """Weighted mean (McMahan et al.); weights default to uniform."""
    dev = resolve(device)
    if weights is None:
        weights = [1.0] * len(updates)
    w = _weights(weights, len(updates), dev)
    return _tree.tree_map(lambda s: torch.tensordot(w, s, dims=([0], [0])),
                          _stack(updates, dev))


def _trimmed(s: torch.Tensor, trim: int) -> torch.Tensor:
    s = torch.sort(s, dim=0).values
    return s[trim:s.shape[0] - trim].mean(0)


def _median(s: torch.Tensor) -> torch.Tensor:
    s = torch.sort(s, dim=0).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) * 0.5


def trimmed_mean(updates: Sequence, trim: int = 1, *,
                 device=DEFAULT_DEVICE, **_):
    """Coordinate-wise trimmed mean, robust to ``trim`` outliers a side."""
    if 2 * trim >= len(updates):
        raise ValueError("trim too large for cohort size")
    return _tree.tree_map(lambda s: _trimmed(s, trim),
                          _stack(updates, resolve(device)))


def coordinate_median(updates: Sequence, *, device=DEFAULT_DEVICE, **_):
    return _tree.tree_map(_median, _stack(updates, resolve(device)))


AGGREGATORS = {
    "fedavg": fedavg,
    "trimmed_mean": trimmed_mean,
    "median": coordinate_median,
}


def aggregate(name: str, updates: Sequence,
              weights: Optional[Sequence[float]] = None, *,
              device=DEFAULT_DEVICE, **kw):
    fn = AGGREGATORS[name]
    if name == "fedavg":
        return fn(updates, weights, device=device)
    return fn(updates, device=device, **kw)


def aggregate_packed(name: str, buffers,
                     weights: Optional[Sequence[float]] = None, *,
                     layout: Optional[PackedLayout] = None,
                     device=DEFAULT_DEVICE, **kw):
    """Aggregate (N, T) packed fp32 client buffers in one reduction.

    FedAvg goes through K1 with weights *normalized* to a weighted mean;
    the robust strategies sort or take the median of the stacked matrix.
    With ``layout`` the (T,) result is unpacked into the parameter tree.
    """
    dev = resolve(device)
    x = as_matrix(buffers, dev)
    n = x.shape[0]
    if name == "fedavg":
        out = masked_sum(x, _weights(weights, n, dev))
    elif name == "trimmed_mean":
        trim = kw.get("trim", 1)
        if 2 * trim >= n:
            raise ValueError("trim too large for cohort size")
        out = _trimmed(x, trim)
    elif name == "median":
        out = _median(x)
    else:
        raise KeyError(name)
    return unpack_pytree(out, layout) if layout is not None else out
