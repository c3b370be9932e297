"""Public compressed-plane combines: K3 ``dequant_reduce`` and K4
``masked_dequant_reduce``.

For a CPU tensor the wrapper runs the plain version (``ref.py``). For a
CUDA tensor it checks the inputs, allocates the output, launches the
hand-written kernel on the current stream and counts the launch in
``LAUNCHES`` (K4 counts its corrected variant apart); it never falls back
and never copies a mistyped, non-contiguous or misaligned input into
shape — it raises.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.compressed_agg import kernel as _k
from repro_torch.kernels.compressed_agg import ref as _ref

CHUNK = _ref.CHUNK

# kernel launches per wrapper since the last reset (plain-version calls on
# CPU tensors do not count)
LAUNCHES: Dict[str, int] = {"dequant_reduce": 0, "masked_dequant_reduce": 0,
                            "masked_dequant_reduce_corrected": 0}

_U32_STORAGE = (torch.int32, torch.uint32)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_tensor(name: str, a: torch.Tensor, dtypes, shape, device):
    if a.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {a.dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(a.shape)} != {tuple(shape)}")
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, expected {device}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_aligned(name: str, a: torch.Tensor):
    if a.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_width(t: int):
    if t % CHUNK:
        raise ValueError(f"T={t} must be a multiple of CHUNK={CHUNK}")


def check_dequant_reduce(q, scales, weights):
    """The checks K3's wrapper runs before a launch."""
    if q.dim() != 2:
        raise ValueError(f"q must be (N, T), got {tuple(q.shape)}")
    n, t = q.shape
    _check_width(t)
    _check_tensor("q", q, (torch.int8,), (n, t), q.device)
    _check_tensor("scales", scales, (torch.float32,), (n, t // CHUNK),
                  q.device)
    _check_tensor("weights", weights, (torch.float32,), (n,), q.device)
    _check_aligned("q", q)


def check_masked_dequant_reduce(z, scales, modulus_bits, corr):
    """The checks K4's wrapper runs before a launch."""
    if z.dim() != 2:
        raise ValueError(f"z must be (N, T), got {tuple(z.shape)}")
    if int(modulus_bits) not in (16, 32):
        raise ValueError(f"modulus_bits must be 16 or 32, got {modulus_bits}")
    n, t = z.shape
    _check_width(t)
    _check_tensor("z", z, _U32_STORAGE, (n, t), z.device)
    _check_tensor("scales", scales, (torch.float32,), (t // CHUNK,),
                  z.device)
    _check_aligned("z", z)
    if corr is not None:
        _check_tensor("corr", corr, _U32_STORAGE, (n, t), z.device)
        _check_aligned("corr", corr)


def dequant_reduce(q: torch.Tensor, scales: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """q: (N, T) int8 (T a CHUNK multiple); scales: (N, T/CHUNK) f32;
    weights: (N,) f32 -> (T,) f32 ``sum_i w_i * dequant(q_i, scales_i)``."""
    if q.device.type == "cpu":
        return _ref.dequant_reduce_ref(q, scales, weights)
    check_dequant_reduce(q, scales, weights)
    out = torch.empty(q.shape[1], dtype=torch.float32, device=q.device)
    _k.dequant_reduce_flat(q, scales, weights, out)
    LAUNCHES["dequant_reduce"] += 1
    return out


def masked_dequant_reduce(z: torch.Tensor, scales: torch.Tensor, *,
                          modulus_bits: int, corr=None) -> torch.Tensor:
    """z: (N, T) 32-bit masked residue streams (int32 bit patterns or
    uint32; T a CHUNK multiple); scales: (T/CHUNK,) f32 cohort-common
    grid; optional corr: (N, T) 32-bit repair corrections -> (T,) f32
    decoded cohort sum. No per-client weights: clients pre-scale."""
    if z.device.type == "cpu":
        return _ref.masked_dequant_reduce_ref(z, scales, int(modulus_bits),
                                              corr=corr)
    check_masked_dequant_reduce(z, scales, modulus_bits, corr)
    out = torch.empty(z.shape[1], dtype=torch.float32, device=z.device)
    _k.masked_dequant_reduce_flat(z, scales, int(modulus_bits), corr, out)
    LAUNCHES["masked_dequant_reduce" if corr is None
             else "masked_dequant_reduce_corrected"] += 1
    return out
