"""Host -> device batch placement (port of ``repro.data.pipeline``)."""
from __future__ import annotations

import torch

from repro_torch import tree as _tree
from repro_torch.sharding.specs import P, NamedSharding


def batch_pspec(mesh, batch_like) -> dict:
    """The batch dim over every data-parallel axis of the mesh ("pod",
    "data") when it divides their product, else replicated."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    def spec(x):
        shape = tuple(x.shape)
        total = 1
        for a in dp:
            total *= mesh.shape[a]
        first = dp if (dp and shape[0] % total == 0) else None
        return P(first, *([None] * (len(shape) - 1)))

    return _tree.tree_map(spec, batch_like)


def shard_batch(mesh, batch):
    """Every array of ``batch`` as a tensor placed by ``batch_pspec``: on a
    mesh over ranks a ``DTensor`` whose batch dim is split over ``"pod"``
    then ``"data"`` (each rank keeps its rows), on a one-device mesh a
    tensor on its device."""
    batch = _tree.tree_map(torch.as_tensor, batch)
    specs = batch_pspec(mesh, batch)
    return _tree.tree_map(lambda x, s: NamedSharding(mesh, s).place(x),
                          batch, specs)
