"""Carry parameter trees between numpy and the port.

The reference draws its init from ``jax.random``, which PyTorch cannot
reproduce. To compute on the same weights, a caller hands the reference's
params over as numpy arrays (nested dicts) and converts them here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.device import DEFAULT_DEVICE, resolve


def params_from_numpy(tree, device=DEFAULT_DEVICE) -> dict:
    """Nested dict of arrays -> nested dict of tensors on ``device``."""
    dev = resolve(device)
    return _tree.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def params_to_numpy(params) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays (bf16 leaves
    come back widened to float32: numpy has no bfloat16)."""
    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return _tree.tree_map(one, params)
