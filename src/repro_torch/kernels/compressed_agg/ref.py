"""Plain PyTorch versions of the compressed-plane combines.

dequant_reduce(q, s, w)            = sum_i w_i * (q_i * expand(s_i))
masked_dequant_reduce(z, s, mbits) = expand(s) * center((sum_i z_i
                                      - sum_i corr_i) mod 2**mbits)

q: (N, T) int8, T a multiple of ``CHUNK``; s: (N, T/CHUNK) f32 per-chunk
scales (K3) or (T/CHUNK,) f32 cohort-common grid (K4); w: (N,) f32.
z, corr: (N, T) 32-bit storage (int32 holding the bit pattern, or
uint32). ``expand`` broadcasts each chunk scale over its 1024 columns.

These are the definitions the CUDA kernels are tested against, and what
the wrappers run for CPU tensors. K4's version emulates uint32 in int64
(torch has no uint32 add, sum or ``>>`` on the CPU): the integer part is
exact and one f32 multiply follows, so the kernel equals it bitwise.
"""
from __future__ import annotations

import torch

CHUNK = 1024          # quantization chunk: one f32 scale per 1024 values
_M32 = 0xFFFFFFFF


def dequant_reduce_ref(q: torch.Tensor, scales: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    n, t = q.shape
    c = t // CHUNK
    deq = (q.to(torch.float32).reshape(n, c, CHUNK)
           * scales.to(torch.float32)[:, :, None]).reshape(n, t)
    return torch.tensordot(weights.to(torch.float32), deq, dims=([0], [0]))


def _as_i64(bits: torch.Tensor) -> torch.Tensor:
    return bits.view(torch.int32).to(torch.int64) & _M32


def centered(s: torch.Tensor, modulus_bits: int) -> torch.Tensor:
    """int64 residue sum (any value; only its low 32 bits count) -> the
    signed value in [-M/2, M/2), M = 2**modulus_bits."""
    r = s & ((1 << modulus_bits) - 1)
    half = 1 << (modulus_bits - 1)
    return r - ((r >= half).to(torch.int64) << modulus_bits)


def masked_dequant_reduce_ref(z: torch.Tensor, scales: torch.Tensor,
                              modulus_bits: int,
                              corr: torch.Tensor = None) -> torch.Tensor:
    s = _as_i64(z).sum(0)
    if corr is not None:
        s = s - _as_i64(corr).sum(0)
    c = centered(s & _M32, int(modulus_bits)).to(torch.float32)
    t = z.shape[1]
    return (c.reshape(t // CHUNK, CHUNK)
            * scales.to(torch.float32)[:, None]).reshape(-1)
