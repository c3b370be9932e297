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
entry a dim, as the reference's. On a mesh over ranks (``launch/mesh.py``)
``place`` / ``to_shardings`` make each leaf a ``DTensor``: an axis named
at dim d is ``Shard(d)``, every other axis ``Replicate()``; ``constrain``
redistributes a ``DTensor`` inside ``mesh_scope(mesh)`` (the reference's
``with mesh:``). On a mesh of one device they move tensors to it. A device
list in one process over several cards cannot hold a leaf (``ValueError``):
that needs ranks.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import tree as _tree
from repro_torch.sharding.mesh import Mesh, current_mesh

# param-name -> (tp_dim, fsdp_dim) counted from the *end* of the shape
# (so stacked (L, ...) leading axes are ignored)
_UP = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "router", "w_dq",
       "w_uq", "w_dkv", "w_uk", "w_uv", "frontend_proj", "unembed",
       "shared_up"}
_DOWN = {"wo", "w_down", "out_proj", "shared_down"}


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
    return _tree.tree_map(
        lambda leaf: _cache_spec(tuple(leaf.shape), mesh, batch), cache_like)


def _cache_spec(shape, mesh, batch: int) -> PartitionSpec:
    """``cache_pspecs``'s spec of a stacked leaf of ``shape``."""
    data = _axis_size(mesh, "data")
    model = _axis_size(mesh, "model")
    nd = len(shape)
    s = [None] * nd
    if nd >= 2 and shape[1] == batch and batch % data == 0 and data > 1:
        s[1] = "data"
    elif nd >= 3 and shape[2] % data == 0 and data > 1:
        s[2] = "data"                         # sequence dim (ring cache)
    for d in range(nd - 1, 1, -1):            # innermost: try model axis
        if s[d] is None and shape[d] % model == 0 and model > 1:
            s[d] = "model"
            break
    return P(*s)


def cache_placements(shape, mesh, *, batch: int) -> list:
    """The DTensor placements on ``mesh`` (over ranks) of a one-layer cache
    leaf of ``shape``: those ``cache_pspecs`` gives the stacked leaf."""
    spec = _cache_spec((1,) + tuple(int(n) for n in shape), mesh, batch)
    return placements(P(*spec[1:]), mesh)


def place_cache(leaf, *, batch: int):
    """A one-layer cache leaf that a prefill computed (a ``DTensor``)
    redistributed to its ``cache_placements``; a plain leaf as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(leaf, DTensor):
        return leaf
    return leaf.redistribute(leaf.device_mesh, cache_placements(
        leaf.shape, Mesh.over_ranks(leaf.device_mesh), batch=batch))


def cache_full(shape, fill, *, dtype, device, batch: int) -> torch.Tensor:
    """A fresh one-layer cache leaf of ``shape`` filled with ``fill``. With
    a mesh over ranks in scope it is a ``DTensor`` placed as
    ``cache_pspecs`` places the stacked leaf (each rank allocates only its
    shard, as the reference's cache comes out of its jitted prefill);
    otherwise a plain tensor on ``device``."""
    mesh = current_mesh()
    shape = tuple(int(n) for n in shape)
    if mesh is None or mesh.device_mesh is None:
        return torch.full(shape, fill, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = cache_placements(shape, mesh, batch=batch)
    local, _ = compute_local_shape_and_global_offset(shape,
                                                     mesh.device_mesh, pl)
    return DTensor.from_local(
        torch.full(local, fill, dtype=dtype, device=device),
        mesh.device_mesh, pl, run_check=False, shape=torch.Size(shape),
        stride=contiguous_stride(shape))


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh axis: an
    axis that the spec names at tensor dim d is ``Shard(d)``, every other
    axis ``Replicate()``. A tuple of axes on one dim shards it over each,
    major to minor, which must be the mesh's own order."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a is not None)
        idx = []
        for a in axes:
            if a not in mesh.axis_names:
                raise ValueError(f"axis {a!r} is not in {mesh}")
            idx.append(mesh.axis_names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} are not in the order of {mesh}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {mesh.axis_names[i]!r} shards two "
                                 f"dims in {spec}")
            out[i] = Shard(d)
    return out


def _check_axes(spec, mesh, ndim: int):
    if len(spec) > ndim:
        raise ValueError(
            f"spec {spec} has more dims than a {ndim}-d leaf")
    for axis in spec:
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None and a not in mesh.axis_names:
                raise ValueError(f"axis {a!r} is not in {mesh}")


def _device_of(mesh) -> torch.device:
    """The one device of a device-list mesh; a list over several cards
    cannot hold a leaf: that needs a mesh of ranks."""
    if mesh.is_abstract:
        raise ValueError(f"{mesh} is abstract: it places nothing")
    devs = {str(d) for d in mesh.device_list}
    if len(devs) > 1:
        raise ValueError(
            f"{mesh} lists {len(devs)} devices in one process: placing a "
            "leaf across cards needs a mesh over ranks (make_host_mesh "
            "after init_ranks)")
    return mesh.device_list[0]


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh. On a mesh over ranks ``place`` makes the leaf a
    ``DTensor`` with ``placements(spec)``; on a one-device mesh it moves
    the leaf to that device."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple:
        """The local shape of a leaf of global ``shape`` (the reference's
        ``NamedSharding.shard_shape``: each named axis divides its dim)."""
        out = list(shape)
        for d, entry in enumerate(self.spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    n = self.mesh.shape[a]
                    if out[d] % n:
                        raise ValueError(f"dim {d} of {tuple(shape)} does "
                                         f"not divide over {a!r} ({n})")
                    out[d] //= n
        return tuple(out)

    def place(self, x) -> torch.Tensor:
        """The whole leaf ``x`` (the same on every rank) placed: each rank
        keeps its own shard, no collective."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        if isinstance(x, DTensor):
            return self.constrain(x)
        x = torch.as_tensor(x)
        _check_axes(self.spec, self.mesh, x.dim())
        if self.mesh.device_mesh is None:
            return x.to(_device_of(self.mesh))
        if x.device.type != "meta":
            x = x.to(self.mesh.local_device)
        return distribute_tensor(x, self.mesh.device_mesh, self.placements,
                                 src_data_rank=None)

    def from_local(self, local: torch.Tensor, shape) -> torch.Tensor:
        """A ``DTensor`` of global ``shape`` from this rank's ``local``
        shard, when each rank builds only its own."""
        from torch.distributed.tensor import DTensor
        if tuple(local.shape) != self.shard_shape(shape):
            raise ValueError(f"local shard {tuple(local.shape)} is not "
                             f"{self.shard_shape(shape)} of {tuple(shape)}")
        return DTensor.from_local(local, self.mesh.device_mesh,
                                  self.placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    def constrain(self, x):
        """A ``DTensor`` redistributed to this spec (collectives as
        needed)."""
        _check_axes(self.spec, self.mesh, x.dim())
        return x.redistribute(self.mesh.device_mesh, self.placements)


def contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def to_shardings(pspecs, mesh):
    """``NamedSharding`` tree for a ``PartitionSpec`` tree; the mesh must
    hold leaves (over ranks or one device)."""
    if mesh.device_mesh is None:
        _device_of(mesh)
    return _tree.tree_map(lambda s: NamedSharding(mesh, s), pspecs)


def place(tree, shardings):
    """Every leaf of ``tree`` placed by its ``NamedSharding``."""
    return _tree.tree_map(lambda a, s: s.place(a), tree, shardings)


def constrain(x, spec: PartitionSpec, mesh=None):
    """The reference's ``with_sharding_constraint``. ``mesh`` defaults to
    the one in ``mesh_scope``; with none it is the identity, as the
    reference's degrades without a mesh in scope. On a mesh over ranks a
    ``DTensor`` is redistributed to ``spec`` and a plain tensor (not part
    of the sharded program) is left as it is; on a one-device mesh ``x``
    moves to that device."""
    from torch.distributed.tensor import DTensor
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return x
    sh = NamedSharding(mesh, P(*spec))
    if mesh.device_mesh is not None:
        return sh.constrain(x) if isinstance(x, DTensor) else x
    return sh.place(x)


def grad_as_placed(x):
    """``x`` in the forward; in the backward its gradient is brought to
    ``x``'s placement as it arrives (a partial one reduce-scattered), for
    a ``DTensor`` ``x``: so a layer's weight gradient stays sharded as the
    weight, and a stack's gradient sums no whole layers. A plain tensor
    as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def placed_layers(stacked):
    """The layers of a stacked tree (leading layer dim), in order. Over
    ranks each leaf goes through ``grad_as_placed``; a stack of plain
    tensors yields its layers as they are."""
    from torch.distributed.tensor import DTensor
    leaves = _tree.leaves(stacked)
    placed = any(isinstance(a, DTensor) for a in leaves)
    for i in range(leaves[0].shape[0]):
        lp = _tree.index(stacked, i)
        yield _tree.tree_map(grad_as_placed, lp) if placed else lp


def replicated_call(fn, *args):
    """``fn(*args)`` on whole tensors. With ``DTensor`` arguments (an op
    that has no sharding rule, or none that keeps its inputs' placement:
    the MoE dispatch's sort and scatter, the loss's labels, a ring write
    into a cache sharded on its slots) each
    is redistributed to ``Replicate()`` first (an all-gather where it is
    sharded, an all-reduce where it is partial) and ``fn`` runs on the
    local copies; its tensor results come back as replicated ``DTensor``s
    on the same mesh, so the program stays one over ranks. With plain
    arguments it is ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_leaves, tree_map
    mesh = next((a.device_mesh for a in tree_leaves(args)
                 if isinstance(a, DTensor)), None)
    if mesh is None:
        return fn(*args)
    whole = [Replicate()] * mesh.ndim
    local = tree_map(lambda a: a.redistribute(mesh, whole).to_local()
                     if isinstance(a, DTensor) else a, args)
    out = fn(*local)
    return tree_map(lambda t: DTensor.from_local(t, mesh, whole,
                                                 run_check=False)
                    if isinstance(t, torch.Tensor) else t, out)

