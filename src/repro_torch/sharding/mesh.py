"""The mesh descriptor of the port (``jax.sharding.Mesh`` /
``AbstractMesh`` in the reference).

A ``Mesh`` is a plain descriptor: axis names, their sizes and, when it
is not abstract, an array of ``torch.device`` laid out in that shape. It
is not a ``torch.distributed`` process group: nothing is initialised and
no collective runs. The placement rules (``sharding/specs.py``,
``data/pipeline.py``) read its axes, and ``to_shardings`` puts tensors on
its device when it has one; ``sharding/agg.py`` uses it with the single
axis ``"shard"``. The launcher's meshes are built in ``launch/mesh.py``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """Named axes of given sizes, over ``devices`` (an array of
    ``torch.device`` of that shape) or abstract (``devices`` None).
    ``shape[name]`` and ``axis_names`` read as the reference's
    ``jax.sharding.Mesh`` / ``AbstractMesh`` do."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence] = None):
        sizes = tuple(int(n) for n in axis_sizes)
        names = tuple(axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"axes {names} do not fit sizes {sizes}")
        if any(n < 1 for n in sizes):
            raise ValueError(f"axis sizes must be positive, got {sizes}")
        self.axis_names: Tuple[str, ...] = names
        self.axis_sizes: Tuple[int, ...] = sizes
        self.shape = dict(zip(names, sizes))
        self.devices = None
        if devices is not None:
            devs = [torch.device(d) for d in devices]
            if len(devs) != int(np.prod(sizes)):
                raise ValueError(
                    f"{len(devs)} devices for a mesh of {sizes}")
            arr = np.empty(len(devs), dtype=object)
            arr[:] = devs
            self.devices = arr.reshape(sizes)

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def is_abstract(self) -> bool:
        return self.devices is None

    @property
    def device_list(self) -> list:
        """The devices in row-major order (repeats kept)."""
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        return list(self.devices.reshape(-1))

    def __repr__(self):
        axes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        where = "abstract" if self.is_abstract else \
            f"on {sorted({str(d) for d in self.device_list})}"
        return f"Mesh({axes}; {where})"
