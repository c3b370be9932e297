"""Packed parameter plane: tree of tensors <-> one contiguous fp32 buffer.

Port of ``repro.core.packing``. Masking is one vectorized pass over the
(T,) buffer, the server-side reduction is one (N, T) weighted sum through
the secure-agg combine kernel, and the result is unpacked once.

Leaves flatten in JAX's order (sorted dict keys, ``repro_torch.tree``), so
the buffer of equal params is bitwise equal to the reference's
``pack_pytree`` and the masks derived over it line up.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.core import telemetry


def dtype_name(dtype: torch.dtype) -> str:
    """NumPy/JAX spelling of a torch dtype (``torch.float32`` -> 'float32')."""
    return str(dtype).removeprefix("torch.")


@dataclass(frozen=True)
class LeafSpec:
    """Static shape/dtype of one leaf inside the packed buffer."""
    shape: Tuple[int, ...]
    dtype: str
    offset: int

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1


@dataclass(frozen=True)
class PackedLayout:
    """Static layout descriptor for a packed buffer."""
    treedef: Any
    leaves: Tuple[LeafSpec, ...]
    total_size: int

    @classmethod
    def for_tree(cls, tree) -> "PackedLayout":
        flat, treedef = _tree.flatten(tree)
        specs: List[LeafSpec] = []
        off = 0
        for leaf in flat:
            spec = LeafSpec(tuple(leaf.shape), dtype_name(leaf.dtype), off)
            specs.append(spec)
            off += spec.size
        return cls(treedef, tuple(specs), off)

    def to_dict(self) -> dict:
        return {"total_size": self.total_size,
                "leaves": [{"shape": list(s.shape), "dtype": s.dtype,
                            "offset": s.offset} for s in self.leaves]}


def pack_pytree(tree, layout: PackedLayout = None):
    """Flatten ``tree`` into one (T,) fp32 buffer on the leaves' device.

    Returns ``(buf, layout)``.
    """
    if layout is None:
        layout = PackedLayout.for_tree(tree)
    flat = _tree.leaves(tree)
    if len(flat) != len(layout.leaves):
        raise ValueError(
            f"tree has {len(flat)} leaves, layout expects "
            f"{len(layout.leaves)}")
    if not flat:
        return torch.zeros((0,), dtype=torch.float32), layout
    with telemetry.current().span("secure.pack", cat="secure",
                                  device=flat[0].device):
        parts = []
        for leaf, spec in zip(flat, layout.leaves):
            if tuple(leaf.shape) != spec.shape:
                raise ValueError(
                    f"leaf shape {tuple(leaf.shape)} != layout {spec.shape}")
            parts.append(leaf.detach().reshape(-1).to(torch.float32))
        return torch.cat(parts), layout


def unpack_pytree(buf: torch.Tensor, layout: PackedLayout):
    """Invert ``pack_pytree``. Each leaf is a fresh tensor (no view into
    ``buf``), so later in-place use of either side cannot alias."""
    buf = buf.reshape(-1)
    if buf.shape[0] != layout.total_size:
        raise ValueError(
            f"buffer has {buf.shape[0]} elements, layout expects "
            f"{layout.total_size}")
    leaves = [buf[s.offset:s.offset + s.size].reshape(s.shape)
              .to(getattr(torch, s.dtype), copy=True)
              for s in layout.leaves]
    return _tree.unflatten(layout.treedef, leaves)


def as_f32(buf, device=None) -> torch.Tensor:
    """A tensor or array as an fp32 tensor on ``device`` (default: where
    it lies; the CPU for an array). A read-only array is copied first."""
    if not isinstance(buf, torch.Tensor):
        buf = torch.from_numpy(np.require(buf, np.float32, ["W"]))
    return buf.to(device or buf.device, torch.float32)


def as_matrix(buffers, device=None) -> torch.Tensor:
    """Coerce a list of (T,) buffers (tensors or arrays) or an (N, T)
    array into one contiguous (N, T) fp32 tensor on ``device`` (default:
    where the first buffer lies)."""
    if isinstance(buffers, (torch.Tensor, np.ndarray)):
        return as_f32(buffers, device).contiguous()
    rows = [as_f32(b, device) for b in buffers]
    if not rows:
        raise ValueError("no buffers")
    return torch.stack([r.reshape(-1).to(rows[0].device) for r in rows])


def pack_many(trees: Sequence, layout: PackedLayout = None):
    """Pack N same-structure trees into one (N, T) fp32 matrix."""
    if not trees:
        raise ValueError("no trees to pack")
    if layout is None:
        layout = PackedLayout.for_tree(trees[0])
    bufs = [pack_pytree(t, layout)[0] for t in trees]
    return torch.stack(bufs), layout
