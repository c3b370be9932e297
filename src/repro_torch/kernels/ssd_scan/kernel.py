"""ctypes binding of K7 the chunked SSD scan (``csrc/ssd_scan.cu``).

``ssd_scan_fwd`` replaces ``repro/kernels/ssd_scan/kernel.py::
ssd_scan_chunked``. It is bound by operations (f32 on the CUDA cores);
the source note in the ``.cu`` file gives the counts and the design.

This function launches on the tensors' current CUDA stream, does not
synchronise, and assumes the caller (``ops.py``) has checked device,
dtypes, shapes, inner-dim contiguity and the shared-memory size. The
library is built on the first call, never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.secure_agg.kernel import _check, _stream

_P = ctypes.c_void_p
_I = ctypes.c_int
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448            # dynamic shared memory a block may use on sm_90


def smem_bytes(q: int, p: int, n: int) -> int:
    """Shared memory a launch needs (the same count as the ``.cu``)."""
    return 4 * (q * p + 2 * q * n + n * p + q * q + 3 * q)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        ctypes.POINTER(ctypes.c_longlong), _I, _P]
    lib.ssd_scan_fwd.restype = _I
    return lib


def ssd_scan_chunked(x, dt, A, B, C, y, state, *, chunk: int):
    """K7: y, state = chunked SSD scan of (x, dt, A, B, C) with chunk
    length ``chunk`` (<= S); y (b,S,H,P) and state (b,H,P,N) contiguous
    f32 outputs."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    strides = (ctypes.c_longlong * 10)(
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
        dt.stride(2), B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    _check(_lib().ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), DTYPES[x.dtype], b, S,
        H, P, N, int(chunk), strides, x.device.index, _stream(x.device)),
        "ssd_scan")
    return y, state
