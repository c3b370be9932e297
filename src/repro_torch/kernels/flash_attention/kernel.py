"""ctypes binding of K6 flash attention (``csrc/flash_attention.cu``).

``flash_attention_fwd`` replaces ``repro/kernels/flash_attention/
kernel.py::flash_attention_bhsd``. It is bound by operations (4*D FLOPs a
visible query-key pair); the source note in the ``.cu`` file gives the
counts and the design.

This function launches on the tensors' current CUDA stream, does not
synchronise, and assumes the caller (``ops.py``) has checked device,
dtype, shapes and that the head dim is contiguous. The library is built
on the first call, never at import.
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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _I, _I,
        ctypes.c_float, _I, _P]
    lib.flash_attention_fwd.restype = _I
    return lib


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, *, scale: float, causal: bool,
                         window: int, softcap: float) -> torch.Tensor:
    """K6: out = attention(q, k, v). q, out (B, Sq, H, D); k, v
    (B, Sk, Hkv, D); any (b, s, h) strides, d contiguous."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(
        *[t.stride(i) for t in (q, k, v, out) for i in range(3)])
    _check(_lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], B, H, Hkv, Sq, Sk, D, strides, float(scale),
        int(causal), int(window), float(softcap), q.device.index,
        _stream(q.device)), "flash_attention")
    return out
