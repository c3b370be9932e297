"""Mesh builders and the H100 hardware model (port of
``repro.launch.mesh``).

The mesh itself is the plain descriptor of ``repro_torch.sharding.mesh``
(re-exported here as ``Mesh``). The production shapes (16 x 16 and
2 x 16 x 16) exist only as abstract descriptors, for the specs; the dry
run's mesh is one card (``make_card_mesh``, ``h100x1`` in its artifacts).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.sharding.mesh import Mesh

__all__ = ["CARD_MESH_NAME", "H100", "HardwareModel", "Mesh",
           "make_card_mesh", "make_host_mesh", "make_production_mesh"]

CARD_MESH_NAME = "h100x1"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, abstract (specs only)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_card_mesh() -> Mesh:
    """One card as an abstract ``(data, model)`` mesh of (1, 1): the dry
    run's mesh, named ``CARD_MESH_NAME`` in its artifacts."""
    return Mesh((1, 1), ("data", "model"))


def make_host_mesh(data: int = 2, model: int = 4, *, pod: int = 0,
                   devices=None) -> Mesh:
    """A small ``(data, model)`` mesh, ``(pod, data, model)`` when ``pod``,
    over ``devices`` (one per mesh position), or abstract when ``devices``
    is None."""
    if pod:
        return Mesh((pod, data, model), ("pod", "data", "model"), devices)
    return Mesh((data, model), ("data", "model"), devices)


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
