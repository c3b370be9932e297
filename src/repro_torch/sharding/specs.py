"""FSDP x TP parameter placement rules (port of ``repro.sharding.specs``).

The rules are the reference's, leaf for leaf:
  * tensor parallel ("model" axis): the Megatron dim of each matrix, the
    output-feature dim of up-projections and the input-feature dim of
    down-projections; MoE expert stacks split the *expert* dim over
    "model" (expert parallelism);
  * FSDP ("data" axis): the remaining feature dim, in train mode only
    (serve mode is TP only: decode needs whole weights every step);
  * "pod": never used for parameters; the multi-pod program stacks a
    leading silo dim on every leaf itself (``launch/train.py``);
  * every rule falls back to replication when a dim does not divide.

A spec is a ``PartitionSpec``: a tuple of axis names and ``None``, one
entry a dim, as the reference's. Placement (``to_shardings``,
``constrain``) puts tensors on the mesh's device when the mesh has one
device. Placing a leaf across more than one card (split or replicated) is
the multi-card work of ROADMAP queue A ("cross-card parameter placement")
and raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import tree as _tree

# param-name -> (tp_dim, fsdp_dim) counted from the *end* of the shape
# (so stacked (L, ...) leading axes are ignored)
_UP = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "router", "w_dq",
       "w_uq", "w_dkv", "w_uk", "w_uv", "frontend_proj", "unembed"}
_DOWN = {"wo", "w_down", "out_proj"}

CROSS_CARD = ("cross-card parameter placement (ROADMAP queue A: needs "
              "more than one card)")


class PartitionSpec(tuple):
    """One entry a dim of a leaf: an axis name, a tuple of axis names, or
    None. A tuple of one name is that name, as in the reference's."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


def _axis_size(mesh, name):
    return mesh.shape[name] if name in mesh.axis_names else 1


def _map_with_path(fn, node, path=()):
    """``fn(path, leaf)`` over a dict tree, keys in sorted order."""
    if isinstance(node, dict):
        return {k: _map_with_path(fn, node[k], path + (k,))
                for k in sorted(node)}
    return fn(path, node)


def _leaf_spec(path, leaf, mesh, mode: str = "train") -> PartitionSpec:
    name = next((n for n in reversed(path) if isinstance(n, str)), "")
    shape = tuple(getattr(leaf, "shape", ()))
    nd = len(shape)
    spec = [None] * nd
    model = _axis_size(mesh, "model")
    data = _axis_size(mesh, "data") if mode == "train" else 1

    def try_shard(dim, axis, size):
        if spec[dim] is None and shape[dim] % size == 0 and size > 1:
            spec[dim] = axis

    if nd <= 1:
        return P(*spec)                       # norms and biases: replicated
    if name in ("w_gate", "w_up", "w_down") and nd >= 4:
        # (L, E, din, dout): expert-parallel over "model", FSDP on din
        try_shard(nd - 3, "model", model)
        try_shard(nd - 2, "data", data)
        return P(*spec)
    if name == "embed":
        # (V, D): vocab-parallel; D stays whole so the unembed needs no
        # all-reduce of the (B, S, V) logits
        try_shard(0, "model", model)
        return P(*spec)
    if name == "meta_tokens":
        return P(*spec)
    if name == "conv_w":
        try_shard(nd - 1, "model", model)
        return P(*spec)
    if name in _DOWN:
        tp_dim, fsdp_dim = nd - 2, nd - 1     # the contracted dim is TP
    else:
        tp_dim, fsdp_dim = nd - 1, nd - 2
    try_shard(tp_dim, "model", model)
    try_shard(fsdp_dim, "data", data)
    return P(*spec)


def param_pspecs(params_like, mesh, mode: str = "train"):
    """``PartitionSpec`` tree for a parameter (or optimizer-state) tree of
    tensors or meta tensors. mode="train": FSDP x TP; mode="serve": TP
    only."""
    return _map_with_path(
        lambda path, leaf: _leaf_spec(path, leaf, mesh, mode), params_like)


def cache_pspecs(cache_like, mesh, *, batch: int):
    """Decode-cache specs: the batch dim (axis 1, after the layer axis)
    over "data" when it divides, else the sequence dim (axis 2); the
    innermost dim that divides over "model"."""
    data = _axis_size(mesh, "data")
    model = _axis_size(mesh, "model")

    def spec(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        s = [None] * nd
        if nd >= 2 and shape[1] == batch and batch % data == 0 and data > 1:
            s[1] = "data"
        elif nd >= 3 and shape[2] % data == 0 and data > 1:
            s[2] = "data"                     # sequence dim (ring cache)
        for d in range(nd - 1, 1, -1):        # innermost: try model axis
            if s[d] is None and shape[d] % model == 0 and model > 1:
                s[d] = "model"
                break
        return P(*s)

    return _tree.tree_map(spec, cache_like)


def _one_device(mesh) -> torch.device:
    """The mesh's device; raises unless every position holds the same
    one."""
    if mesh.is_abstract:
        raise ValueError(f"{mesh} is abstract: it places nothing")
    devs = {str(d) for d in mesh.device_list}
    if len(devs) > 1:
        raise NotImplementedError(
            f"{mesh} spans {len(devs)} cards: {CROSS_CARD}")
    return mesh.device_list[0]


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; ``place`` puts a tensor where the spec says."""
    mesh: object
    spec: PartitionSpec

    @property
    def device(self) -> torch.device:
        return _one_device(self.mesh)

    def place(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        if len(self.spec) > x.dim():
            raise ValueError(
                f"spec {self.spec} has more dims than a {x.dim()}-d leaf")
        for axis in self.spec:
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is not None and a not in self.mesh.axis_names:
                    raise ValueError(f"axis {a!r} is not in {self.mesh}")
        return x.to(self.device)


def to_shardings(pspecs, mesh):
    """``NamedSharding`` tree for a ``PartitionSpec`` tree."""
    _one_device(mesh)
    return _tree.tree_map(lambda s: NamedSharding(mesh, s), pspecs)


def place(tree, shardings):
    """Every leaf of ``tree`` placed by its ``NamedSharding``."""
    return _tree.tree_map(lambda a, s: s.place(a), tree, shardings)


def constrain(x, spec: PartitionSpec, mesh=None):
    """The reference's ``with_sharding_constraint``: the identity when no
    mesh is given (as the reference's degrades without a mesh in scope),
    else ``x`` placed on the mesh."""
    if mesh is None:
        return x
    return NamedSharding(mesh, P(*spec)).place(x)
