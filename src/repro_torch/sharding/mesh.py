"""The mesh of the port (``jax.sharding.Mesh`` / ``AbstractMesh`` in the
reference).

A ``Mesh`` names its axes and their sizes, and is one of three kinds:

* abstract (no devices): the placement rules (``sharding/specs.py``,
  ``data/pipeline.py``) read its axes and nothing is placed;
* over a device list in one process (an array of ``torch.device`` of
  the mesh's shape): ``sharding/agg.py``'s T split, one controller over
  several devices with no collective, and the one-card placements;
* over ranks: a ``torch.distributed.device_mesh.DeviceMesh`` over an
  initialised process group (``launch/mesh.py::make_host_mesh``), where
  a leaf is a ``DTensor`` placed by its ``PartitionSpec`` and every
  collective is a ``torch.distributed`` one (gloo on the CPU, nccl on
  the card, the fake group for the dry run).

``mesh_scope(mesh)`` is the reference's ``with mesh:``: ``constrain``
and the model's sharding hooks read the mesh in scope (``current_mesh``)
and do nothing without one.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


class Mesh:
    """Named axes of given sizes, over ``devices`` (an array of
    ``torch.device`` of that shape), over the ranks of ``device_mesh`` (a
    ``DeviceMesh`` with these axis names), or abstract. ``shape[name]``
    and ``axis_names`` read as the reference's ``jax.sharding.Mesh`` /
    ``AbstractMesh`` do."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence] = None, *, device_mesh=None):
        sizes = tuple(int(n) for n in axis_sizes)
        names = tuple(axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"axes {names} do not fit sizes {sizes}")
        if any(n < 1 for n in sizes):
            raise ValueError(f"axis sizes must be positive, got {sizes}")
        if devices is not None and device_mesh is not None:
            raise ValueError("a mesh is over devices or over ranks, not both")
        self.axis_names: Tuple[str, ...] = names
        self.axis_sizes: Tuple[int, ...] = sizes
        self.shape = dict(zip(names, sizes))
        self.devices = None
        self.device_mesh = None
        if devices is not None:
            devs = [torch.device(d) for d in devices]
            if len(devs) != int(np.prod(sizes)):
                raise ValueError(
                    f"{len(devs)} devices for a mesh of {sizes}")
            arr = np.empty(len(devs), dtype=object)
            arr[:] = devs
            self.devices = arr.reshape(sizes)
        if device_mesh is not None:
            if (tuple(device_mesh.mesh_dim_names or ()) != names
                    or tuple(device_mesh.shape) != sizes):
                raise ValueError(
                    f"device mesh {device_mesh} is not a mesh of "
                    f"{dict(zip(names, sizes))}")
            self.device_mesh = device_mesh

    @classmethod
    def over_ranks(cls, device_mesh) -> "Mesh":
        """The mesh of a ``DeviceMesh`` with named dims."""
        return cls(tuple(device_mesh.shape), device_mesh.mesh_dim_names,
                   device_mesh=device_mesh)

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def is_abstract(self) -> bool:
        return self.devices is None and self.device_mesh is None

    @property
    def device_list(self) -> list:
        """The devices in row-major order (repeats kept)."""
        if self.devices is None:
            raise ValueError(f"{self} has no device list")
        return list(self.devices.reshape(-1))

    @property
    def local_device(self) -> torch.device:
        """This rank's device on a mesh over ranks."""
        if self.device_mesh is None:
            raise ValueError(f"{self} is not over ranks")
        kind = self.device_mesh.device_type
        if kind == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(kind)

    def __repr__(self):
        axes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        if self.device_mesh is not None:
            where = f"over {self.device_mesh.device_type} ranks"
        elif self.is_abstract:
            where = "abstract"
        else:
            where = f"on {sorted({str(d) for d in self.device_list})}"
        return f"Mesh({axes}; {where})"


_SCOPE = threading.local()


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh of ``mesh_scope``, or None."""
    stack = getattr(_SCOPE, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def mesh_scope(mesh: Optional[Mesh]):
    """``with mesh_scope(mesh):`` is the reference's ``with mesh:``:
    ``constrain`` and the model's sharding hooks read ``mesh`` inside."""
    stack = getattr(_SCOPE, "stack", None)
    if stack is None:
        stack = _SCOPE.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def sharded_program(leaves):
    """Around a program whose leaves are ``DTensor``s: a plain tensor that
    the program makes (positions, masks, constants) counts as replicated
    on every rank (``implicit_replication``), and a view that ``DTensor``
    cannot shard (a dim split or merged unevenly over its ranks) gathers
    the dims it reshapes first (``_EvenViews``), as XLA reshards around a
    reshape. A no-op for plain leaves."""
    from torch.distributed.tensor import DTensor
    if not any(isinstance(a, DTensor) for a in leaves):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    stack = contextlib.ExitStack()
    stack.enter_context(implicit_replication())
    stack.enter_context(_EvenViews())
    return stack


def program_scope():
    """A context factory that re-enters, on whatever thread enters it,
    the mesh scope and the DTensor implicit replication that are on
    here. A checkpoint's recompute runs in the backward, which may run on
    autograd's device thread, where neither is set (both are per thread;
    the dispatch modes, ``_EvenViews`` among them, follow the backward
    there themselves). None outside a program over ranks (no mesh of
    ranks in scope, no implicit replication): there the recompute needs
    neither."""
    from torch.distributed.tensor import DTensor
    mesh = current_mesh()
    implicit = bool(DTensor._op_dispatcher._allow_implicit_replication)
    if not implicit and (mesh is None or mesh.device_mesh is None):
        return None

    @contextlib.contextmanager
    def scope():
        d = DTensor._op_dispatcher
        before = d._allow_implicit_replication
        d._allow_implicit_replication = implicit
        try:
            with mesh_scope(mesh):
                yield
        finally:
            d._allow_implicit_replication = before
    return scope


_VIEWS = ("view.default", "_unsafe_view.default", "reshape.default")


class _EvenViews(TorchDispatchMode):
    """A ``DTensor`` view whose sharding propagation refuses it (a dim
    split or merged unevenly over its ranks) runs again on the input with
    every dim from the first reshaped one on replicated."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        kwargs = kwargs or {}
        x = args[0] if args else None
        if not (isinstance(x, DTensor) and
                f"{func._opname}.{func._overloadname}" in _VIEWS):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if "unevenly sharded" not in str(e):
                raise
        shape = tuple(args[1])
        first = next((i for i, (a, b) in enumerate(zip(x.shape, shape))
                      if a != b), min(len(shape), x.dim()))
        whole = [Replicate() if isinstance(p, Shard) and p.dim >= first
                 else p for p in x.placements]
        return func(x.redistribute(x.device_mesh, whole), *args[1:],
                    **kwargs)
