"""ctypes binding of the secure-agg combine kernels (``csrc/secure_agg.cu``).

K1 ``masked_sum_flat`` replaces ``repro/kernels/secure_agg/kernel.py::
masked_sum_flat``; K2 ``masked_sum_corrected_flat`` replaces
``masked_sum_corrected_flat`` there, and K5 ``secure_agg_combine_flat``
replaces ``secure_agg_combine_flat``. All are bound by bytes: (N+1)*T*4
(K1), (2N+1)*T*4 (K2) and N*T + 4*T (K5) over the card's HBM rate. The
source note in the ``.cu`` file explains the design.

These functions launch on the tensors' current CUDA stream, do not
synchronise, and assume the caller (``ops.py``) has checked device, dtype,
shape and contiguity. The library is built on the first call, never at
import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("secure_agg")
    lib.masked_sum_f32.argtypes = [_P, _P, _P, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_int, _P]
    lib.masked_sum_f32.restype = ctypes.c_int
    lib.masked_sum_corrected_f32.argtypes = [
        _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P]
    lib.masked_sum_corrected_f32.restype = ctypes.c_int
    lib.secure_agg_combine_f32.argtypes = [_P, _P, _P, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_int,
                                           _P]
    lib.secure_agg_combine_f32.restype = ctypes.c_int
    return lib


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _call(fn, what: str, dev: torch.device, *args):
    """``fn(*args, device index, stream)`` with ``dev`` current. The
    sources make the launch's device current and leave it so; the
    context puts the caller's current device back."""
    with torch.cuda.device(dev):
        _check(fn(*args, dev.index, _stream(dev)), what)


def masked_sum_flat(x: torch.Tensor, w: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    """K1: out = sum_i w_i * x_i. x (N, T), w (N,), out (T,) fp32 CUDA."""
    n, t = x.shape
    _call(_lib().masked_sum_f32, "masked_sum", x.device, x.data_ptr(),
          w.data_ptr(), out.data_ptr(), n, t)
    return out


def masked_sum_corrected_flat(x: torch.Tensor, c: torch.Tensor,
                              w: torch.Tensor,
                              out: torch.Tensor) -> torch.Tensor:
    """K2: out = sum_i w_i * (x_i - c_i). x, c (N, T), w (N,), out (T,)."""
    n, t = x.shape
    _call(_lib().masked_sum_corrected_f32, "masked_sum_corrected",
          x.device, x.data_ptr(), c.data_ptr(), w.data_ptr(),
          out.data_ptr(), n, t)
    return out


def secure_agg_combine_flat(q: torch.Tensor, ws: torch.Tensor,
                            out: torch.Tensor) -> torch.Tensor:
    """K5: out = sum_i ws_i * float(q_i). q (N, T) int8, ws (N,) f32 (the
    weights times the per-client scales), out (T,) f32."""
    n, t = q.shape
    _call(_lib().secure_agg_combine_f32, "secure_agg_combine", q.device,
          q.data_ptr(), ws.data_ptr(), out.data_ptr(), n, t)
    return out
