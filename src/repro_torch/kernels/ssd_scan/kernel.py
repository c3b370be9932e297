"""ctypes binding of K7 the chunked SSD scan (``csrc/ssd_scan.cu``).

``ssd_scan_fwd`` replaces ``repro/kernels/ssd_scan/kernel.py::
ssd_scan_chunked``. It is bound by operations (f32 on the CUDA cores);
the source note in the ``.cu`` file gives the counts and the design: three
launches (chunk states and C B^T, state passing, output) behind one call,
with scratch that ``ssd_scan_chunked`` allocates.

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
from repro_torch.kernels.secure_agg.kernel import _call

_P = ctypes.c_void_p
_I = ctypes.c_int
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448            # dynamic shared memory a block may use on sm_90


PAD_ROWS = 8                 # the kernels pad the chunk to a multiple
TILE_COLS = 4                # columns of y a thread (float4), so P % 4 == 0


def padded_chunk(q: int) -> int:
    return -(-q // PAD_ROWS) * PAD_ROWS


def smem_bytes(q: int, p: int, n: int) -> int:
    """Shared memory the largest pass needs (the same count as the
    ``.cu``): the output pass's decayed C B^T, xb, C, the entering state,
    L and dt, or the chunk pass's, whichever is larger."""
    qp = padded_chunk(q)
    out = qp * qp + qp * p + n * qp + n * p + 2 * qp
    chunk = max(2 * qp + qp * p + qp * n, 2 * qp * n)
    return 4 * max(out, chunk)


def scratch_shapes(b: int, S: int, H: int, P: int, N: int, q: int,
                   g: int = 1):
    """The f32 scratch of one call: each group's C B^T transposed
    (b, nc * g, Qp, Qp), L (b, nc, H, Qp), each chunk's own state and the
    state entering it (b, nc, H, N, P) each."""
    nc, qp = -(-S // q), padded_chunk(q)
    return {"cbt": (b, nc * g, qp, qp), "L": (b, nc, H, qp),
            "states": (b, nc, H, N, P), "entering": (b, nc, H, N, P)}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of a library built from ``ssd_scan.cu`` (or
    from a variant of it)."""
    lib.ssd_scan_fwd.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _I, _I,
        ctypes.POINTER(ctypes.c_longlong), _I, _P]
    lib.ssd_scan_fwd.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("ssd_scan"))


def ssd_scan_chunked(x, dt, A, B, C, y, state, *, chunk: int,
                     lib: ctypes.CDLL = None):
    """K7: y, state = chunked SSD scan of (x, dt, A, B, C) with chunk
    length ``chunk`` (<= S); B and C (b,S,N), or (b,S,G,N) in G groups;
    y (b,S,H,P) and state (b,H,P,N) contiguous f32 outputs. ``lib``: a
    library built from a variant of the source (``bind`` first); the
    committed one by default."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    G = B.shape[2] if B.dim() == 4 else 1
    gs = (B.stride(2), C.stride(2)) if B.dim() == 4 else (0, 0)
    scratch = {k: torch.empty(shape, dtype=torch.float32, device=x.device)
               for k, shape in scratch_shapes(b, S, H, P, N, chunk,
                                              G).items()}
    strides = (ctypes.c_longlong * 12)(
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
        dt.stride(2), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        *gs)
    _call((lib or _lib()).ssd_scan_fwd, "ssd_scan", x.device,
          x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
          C.data_ptr(), y.data_ptr(), state.data_ptr(),
          *(scratch[k].data_ptr()
            for k in ("cbt", "L", "states", "entering")),
          DTYPES[x.dtype], b, S, H, P, N, G, int(chunk), strides)
    return y, state
