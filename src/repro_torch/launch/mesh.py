"""Mesh builders and the H100 hardware model (port of
``repro.launch.mesh``).

A mesh is ``repro_torch.sharding.mesh.Mesh`` (re-exported here). With no
process group initialised the builders return the reference's shapes as
abstract descriptors (specs only) or over a device list. Once a group is
up (``init_ranks``: gloo on the CPU, nccl on the card, or the ``fake``
group at 256 or 512 ranks for the dry run) they return a mesh over its
ranks: a ``DeviceMesh`` with the reference's axis names and order, its
device type the backend's (``cpu`` for gloo and fake, ``cuda`` for
nccl).

Mesh names in the dry run's artifacts: ``h100x1`` (one card),
``h100x16x16`` and ``h100x2x16x16`` (the production meshes).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.sharding.mesh import Mesh

__all__ = ["CARD_MESH_NAME", "H100", "HardwareModel", "Mesh", "init_ranks",
           "make_card_mesh", "make_host_mesh", "make_production_mesh",
           "mesh_name", "rank_mesh"]

CARD_MESH_NAME = "h100x1"
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}
_DEVICE_TYPE = {"gloo": "cpu", "fake": "cpu", "nccl": "cuda"}


def init_ranks(backend: str, world: int, rank: int,
               init_file: Optional[str] = None) -> None:
    """Initialise the default process group: ``backend`` ``"gloo"`` or
    ``"nccl"`` over a ``FileStore`` at ``init_file`` (no TCP port to race
    for), or ``"fake"`` (rank 0 of a world that exists only in shapes:
    every collective returns at once; ``FakeStore`` needs no file). nccl
    takes this rank's card, ``cuda:<rank % count>``."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
        return
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    if init_file is None:
        raise ValueError(f"the {backend} group needs an init file")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(os.fspath(init_file), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)


def rank_mesh(sizes, names) -> Mesh:
    """A mesh of ``names`` of ``sizes`` over the default group's ranks,
    row-major (their product must be the world size)."""
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    n = 1
    for s in sizes:
        n *= s
    if n != world:
        raise ValueError(f"a mesh of {dict(zip(names, sizes))} needs {n} "
                         f"ranks, the group has {world}")
    kind = _DEVICE_TYPE[dist.get_backend()]
    dm = DeviceMesh(kind, torch.arange(world).reshape(sizes),
                    mesh_dim_names=tuple(names))
    return Mesh.over_ranks(dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, (16, 16) and (2, 16, 16): over
    the group's ranks when one is initialised, else abstract."""
    sizes, names = PRODUCTION_SHAPES[bool(multi_pod)]
    if dist.is_initialized():
        return rank_mesh(sizes, names)
    return Mesh(sizes, names)


def mesh_name(mesh: Mesh) -> str:
    """The artifacts' name of a mesh: ``h100x1`` for one card, else
    ``h100x`` and the axis sizes (``h100x16x16``, ``h100x2x16x16``)."""
    if mesh.size == 1:
        return CARD_MESH_NAME
    return "h100x" + "x".join(str(s) for s in mesh.axis_sizes)


def make_card_mesh() -> Mesh:
    """One card as an abstract ``(data, model)`` mesh of (1, 1): the dry
    run's mesh, named ``CARD_MESH_NAME`` in its artifacts."""
    return Mesh((1, 1), ("data", "model"))


def make_host_mesh(data: int = 2, model: int = 4, *, pod: int = 0,
                   devices=None) -> Mesh:
    """A small ``(data, model)`` mesh, ``(pod, data, model)`` when ``pod``:
    over ``devices`` (one per position) when given, else over the
    initialised group's ranks, else abstract."""
    sizes, names = ((pod, data, model), ("pod", "data", "model")) if pod \
        else ((data, model), ("data", "model"))
    if devices is None and dist.is_initialized():
        return rank_mesh(sizes, names)
    return Mesh(sizes, names, devices)


@dataclass(frozen=True)
class HardwareModel:
    """Constants of one accelerator for the roofline terms."""
    name: str
    peak_flops_bf16: float        # FLOP/s, dense tensor cores
    peak_flops_fp32: float        # FLOP/s, outside the tensor cores
    hbm_bw: float                 # bytes/s
    hbm_per_chip: float           # bytes
    nvlink_bw: float              # bytes/s a card, both directions
    pcie_bw: float                # bytes/s a card, both directions
    network_bw: float             # bytes/s a card, across nodes


# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: BF16 tensor core
# 1,979 TFLOP/s with sparsity (989 dense), FP32 67 TFLOP/s, 80 GB of HBM3
# at 3.35 TB/s, NVLink 4 at 900 GB/s, PCIe Gen5 at 128 GB/s. Across nodes:
# the NVIDIA DGX H100 user guide's one 400 Gb/s ConnectX-7 port a GPU,
# 50 GB/s a card
H100 = HardwareModel(name="h100_sxm", peak_flops_bf16=989e12,
                     peak_flops_fp32=67e12, hbm_bw=3.35e12, hbm_per_chip=80e9,
                     nvlink_bw=900e9, pcie_bw=128e9, network_bw=50e9)
