"""Public SSD-scan op K7, used by ``models/ssm.py`` when impl="kernel".

For a CPU tensor the wrapper runs the plain chunked form
(``ref.ssd_chunked``). For a CUDA tensor it checks the inputs, allocates
the outputs and scratch, launches the hand-written kernels (three passes)
on the current stream and counts the call as one launch in
``LAUNCHES``; it never falls back — it raises on what the kernels do not
take, and on inputs that need a gradient (there is no backward kernel
yet).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.ssd_scan import kernel as _k
from repro_torch.kernels.ssd_scan import ref as _ref

# kernel launches since the last reset (plain-version calls on CPU tensors
# do not count)
LAUNCHES: Dict[str, int] = {"ssd_scan": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_ssd_scan(x, dt, A, B, C, chunk):
    """The checks K7's wrapper runs before a launch."""
    if x.dim() != 4:
        raise ValueError(f"x must be (b,S,H,P), got {tuple(x.shape)}")
    b, S, H, P = x.shape
    if B.dim() not in (3, 4) or tuple(B.shape[:2]) != (b, S) \
            or tuple(C.shape) != tuple(B.shape):
        raise ValueError(f"B {tuple(B.shape)} / C {tuple(C.shape)} must be "
                         f"({b}, {S}, N) or ({b}, {S}, G, N)")
    if B.dim() == 4 and (B.shape[2] < 1 or H % B.shape[2]):
        raise ValueError(f"{B.shape[2]} B/C groups do not divide {H} heads")
    if tuple(dt.shape) != (b, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} must "
                         f"be ({b}, {S}, {H}) / ({H},)")
    if x.dtype not in _k.DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B, C must share float32 or bfloat16, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, "
                        f"{A.dtype}")
    for name, a in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
    for name, a in (("x", x), ("B", B), ("C", C), ("A", A)):
        if a.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    if int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if P % _k.TILE_COLS:
        raise ValueError(f"head dim P {P} is not a multiple of "
                         f"{_k.TILE_COLS} (the kernel's float4 tiles)")
    q = min(int(chunk), S) or 1
    need = _k.smem_bytes(q, P, B.shape[-1])
    if need > _k.MAX_SMEM:
        raise ValueError(f"chunk {q} x P {P} x N {B.shape[-1]} needs {need} "
                         f"bytes of shared memory, more than {_k.MAX_SMEM}")
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x, dt, A, B, C)):
        raise NotImplementedError(
            "ssd_scan has no backward kernel yet: train through the "
            "impl='xla' path")


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """x: (b,S,H,P); dt: (b,S,H) f32; A: (H,) f32; B,C: (b,S,N), or
    (b,S,G,N) with head h reading group h // (H // G).

    Returns (y (b,S,H,P) f32, final state (b,H,P,N) f32)."""
    if x.device.type == "cpu":
        return _ref.ssd_chunked(x, dt, A, B, C, chunk=chunk)
    check_ssd_scan(x, dt, A, B, C, chunk)
    b, S, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty((b, S, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    _k.ssd_scan_chunked(x, dt, A, B, C, y, state,
                        chunk=min(int(chunk), S) or 1)
    LAUNCHES["ssd_scan"] += 1
    return y, state
