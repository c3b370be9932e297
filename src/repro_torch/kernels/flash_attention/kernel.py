"""ctypes binding of K6 flash attention (``csrc/flash_attention.cu``).

Two kernels replace ``repro/kernels/flash_attention/kernel.py::
flash_attention_bhsd``, chosen by the inputs' type: bfloat16 goes to
``flash_attention_bf16_fwd`` (wgmma on the tensor cores, TMA loads),
float32 to ``flash_attention_f32_fwd`` (the CUDA cores; bf16 tensor cores
cannot hold the float32 tolerance). Both are bound by operations (4*D
FLOPs a visible query-key pair); the source note in the ``.cu`` file
gives the counts and the design.

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
from repro_torch.kernels.secure_agg.kernel import _call

_P = ctypes.c_void_p
_I = ctypes.c_int
# the C entry point of each input type
ENTRY = {torch.float32: "flash_attention_f32_fwd",
         torch.bfloat16: "flash_attention_bf16_fwd"}
DTYPES = tuple(ENTRY)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``flash_attention.cu`` (or from a variant of it)."""
    for name in ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _I, _I,
            ctypes.c_float, _I, _P]
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("flash_attention"))


def bsh_strides(t: torch.Tensor):
    """(b, s, h) element strides as the kernels read them: a dim of size 1
    is never stepped over, so its stride is taken as D (any 16-byte
    multiple would do for the TMA maps)."""
    return [t.stride(i) if t.shape[i] != 1 else t.shape[3]
            for i in range(3)]


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, *, scale: float, causal: bool,
                         window: int, softcap: float,
                         lib: ctypes.CDLL = None) -> torch.Tensor:
    """K6: out = attention(q, k, v). q, out (B, Sq, H, D); k, v
    (B, Sk, Hkv, D); any (b, s, h) strides, d contiguous (bfloat16: the
    16-byte alignment ``ops.check_flash_attention`` checks). ``lib``: a
    library built from a variant of the source (``bind`` first); the
    committed one by default."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, out) for s in bsh_strides(t)])
    _call(getattr(lib or _lib(), ENTRY[q.dtype]), "flash_attention",
          q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
          out.data_ptr(), B, H, Hkv, Sq, Sk, D, strides, float(scale),
          int(causal), int(window), float(softcap))
    return out
