"""ctypes binding of the compressed-plane combines (``csrc/compressed_agg.cu``).

K3 ``dequant_reduce_f32`` replaces ``repro/kernels/compressed_agg/kernel.py::
dequant_reduce_flat``; K4 ``masked_dequant_reduce_u32`` replaces
``masked_dequant_reduce_flat`` there, with and without corrections. Both
are bound by bytes; the source note in the ``.cu`` file gives the counts
and the design.

These functions launch on the tensors' current CUDA stream, do not
synchronise, and assume the caller (``ops.py``) has checked device, dtype,
shape, contiguity and alignment. The library is built on the first call,
never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.secure_agg.kernel import _call

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("compressed_agg")
    lib.dequant_reduce_f32.argtypes = [_P, _P, _P, _P, ctypes.c_int,
                                       ctypes.c_longlong, ctypes.c_int, _P]
    lib.dequant_reduce_f32.restype = ctypes.c_int
    lib.masked_dequant_reduce_u32.argtypes = [
        _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, _P]
    lib.masked_dequant_reduce_u32.restype = ctypes.c_int
    return lib


def dequant_reduce_flat(q: torch.Tensor, scales: torch.Tensor,
                        w: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """K3: out = sum_i w_i * q_i * expand(scales_i). q (N, T) int8,
    scales (N, T/1024), w (N,), out (T,) f32 CUDA."""
    n, t = q.shape
    _call(_lib().dequant_reduce_f32, "dequant_reduce", q.device,
          q.data_ptr(), scales.data_ptr(), w.data_ptr(), out.data_ptr(), n,
          t)
    return out


def masked_dequant_reduce_flat(z: torch.Tensor, scales: torch.Tensor,
                               modulus_bits: int, corr, out: torch.Tensor
                               ) -> torch.Tensor:
    """K4: out = expand(scales) * center((sum_i z_i - sum_i corr_i) mod
    2**modulus_bits). z, corr (N, T) 32-bit, scales (T/1024,), out (T,)."""
    n, t = z.shape
    _call(_lib().masked_dequant_reduce_u32, "masked_dequant_reduce",
          z.device, z.data_ptr(),
          None if corr is None else corr.data_ptr(), scales.data_ptr(),
          out.data_ptr(), n, t, int(modulus_bits))
    return out
