"""Model identity digest (port of ``repro.checkpoint.ckpt.pytree_digest``).

The byte stream is the reference's: per leaf in JAX order, the NumPy dtype
name, ``str`` of the shape tuple, then the leaf's C-order bytes. Equal
params therefore give equal digests on both sides.
"""
from __future__ import annotations

import hashlib

import torch

from repro_torch import tree as _tree


def _leaf_bytes(leaf: torch.Tensor) -> bytes:
    leaf = leaf.detach().cpu().contiguous()
    if leaf.dtype == torch.bfloat16:    # numpy has no bfloat16: same bits
        return leaf.view(torch.int16).numpy().tobytes()
    return leaf.numpy().tobytes()


def pytree_digest(tree) -> str:
    """SHA256 over all leaf bytes — the model identity used for tracking."""
    # imported here: ``repro_torch.core`` imports this module (its server
    # and client digest models)
    from repro_torch.core.packing import dtype_name
    h = hashlib.sha256()
    for leaf in _tree.leaves(tree):
        h.update(dtype_name(leaf.dtype).encode())
        h.update(str(tuple(leaf.shape)).encode())
        h.update(_leaf_bytes(leaf))
    return h.hexdigest()
