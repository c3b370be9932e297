"""T-axis split of the server aggregation kernels (port of
``repro.sharding.agg``).

The four server reductions (K1 ``masked_sum``, K2 ``masked_sum_corrected``,
K3 ``dequant_reduce``, K4 ``masked_dequant_reduce``) are independent over
the packed parameter axis T: each output element depends on one column of
the (N, T) cohort matrix. Over a 1-D ``("shard",)`` mesh each shard's
column slab is copied to its device and reduced there by the unsplit
op's wrapper (one kernel launch a shard on a CUDA device, the plain
version on the CPU); the (T,) result is gathered on the mesh's first
device and sliced back to T. No collective runs.

The reference's rules:
  * only T is split; the client axis N stays whole on every shard;
  * T is zero-padded to a multiple of ``n_shards * granule``: ``LANE``
    (128) columns for the f32 pair, ``CHUNK`` (1024) for the compressed
    pair, whose T must already be a CHUNK multiple (else ``ValueError``).
    Zero columns are exact identities for every op;
  * with no mesh (``agg_mesh()`` is None: fewer than two devices) the
    caller runs the plain op.

The result lies on the mesh's first device, whichever device the inputs
were on. A mesh may name one device several times
(``agg_mesh([cuda:0] * 2)``): the split then runs on one card, which is
how a one-card host exercises it. The streaming sinks take such a mesh
(``core/streaming.py``, ``mesh=``): they keep one accumulator slab a
shard (``masked_sum_slabs``, ``dequant_reduce_slabs``) and gather at
finalize. ``mesh="auto"`` there is ``agg_mesh()``, so one card runs the
unsplit kernels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.compressed_agg import ops as _comp_ops
from repro_torch.kernels.secure_agg import ops as _sec_ops
from repro_torch.sharding.mesh import Mesh

AXIS = "shard"
CHUNK = _comp_ops.CHUNK      # dequant column granule (1024 values)
LANE = 128                   # fp32 column granule


def agg_mesh(devices=None, *, min_devices: int = 2) -> Optional[Mesh]:
    """1-D aggregation mesh over ``devices`` (default: the visible CUDA
    devices), or ``None`` when there are fewer than ``min_devices``: the
    caller then runs the plain op. Not cached: tests build meshes over
    device lists."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if len(devs) < min_devices:
        return None
    return Mesh((len(devs),), (AXIS,), devs)


def _t_pad(t: int, n_shards: int, chunk: int) -> int:
    return (-t) % (n_shards * chunk)


def _slab(a: torch.Tensor, lo: int, hi: int, width: int,
          device) -> torch.Tensor:
    """Columns ``lo:hi`` of ``a`` (the last axis) as a contiguous tensor
    of ``width`` columns on ``device``, zero past ``hi - lo``: one copy
    of the shard's columns, padding included."""
    n = max(0, min(hi, a.shape[-1]) - lo)
    shape = tuple(a.shape[:-1]) + (width,)
    out = (torch.empty if n == width else torch.zeros)(
        shape, dtype=a.dtype, device=device)
    if n:
        out[..., :n].copy_(a[..., lo:lo + n])
    return out


def _split(mesh: Mesh, t: int, granule: int):
    """``(device, lo, hi)`` of each shard over the padded T."""
    if AXIS not in mesh.axis_names or len(mesh.axis_names) != 1:
        raise ValueError(f"not an aggregation mesh: {mesh}")
    devs = mesh.device_list
    width = (t + _t_pad(t, len(devs), granule)) // len(devs)
    return [(d, i * width, (i + 1) * width) for i, d in enumerate(devs)]


def gather(outs, t: int) -> torch.Tensor:
    """The shards' results, concatenated on the first shard's device and
    cut back to T."""
    dev = outs[0].device
    return torch.cat([o.to(dev) for o in outs])[:t]


def masked_sum_slabs(x, weights, *, mesh: Mesh) -> list:
    """K1 once a shard: each shard's (width,) f32 result on its device,
    over T zero-padded to the shards' widths."""
    x = torch.as_tensor(x, dtype=torch.float32)
    w = torch.as_tensor(weights, dtype=torch.float32)
    return [_sec_ops.masked_sum(_slab(x, lo, hi, hi - lo, d), w.to(d))
            for d, lo, hi in _split(mesh, x.shape[1], LANE)]


def sharded_masked_sum(x, weights, *, mesh: Mesh) -> torch.Tensor:
    """(N, T) f32 x (N,) f32 -> (T,) f32, K1 once a shard."""
    return gather(masked_sum_slabs(x, weights, mesh=mesh), x.shape[1])


def sharded_masked_sum_corrected(x, corr, weights, *,
                                 mesh: Mesh) -> torch.Tensor:
    """Dropout-repair combine, both (N, T) operands split; K2 once a
    shard."""
    x = torch.as_tensor(x, dtype=torch.float32)
    c = torch.as_tensor(corr, dtype=torch.float32)
    w = torch.as_tensor(weights, dtype=torch.float32)
    t = x.shape[1]
    outs = [_sec_ops.masked_sum_corrected(
        _slab(x, lo, hi, hi - lo, d), _slab(c, lo, hi, hi - lo, d), w.to(d))
        for d, lo, hi in _split(mesh, t, LANE)]
    return gather(outs, t)


def _check_chunked(t: int):
    if t % CHUNK:
        raise ValueError(f"T={t} must be a multiple of CHUNK={CHUNK}")


def dequant_reduce_slabs(q, scales, weights, *, mesh: Mesh) -> list:
    """K3 once a shard: each shard's (width,) f32 result on its device.
    T must already be a CHUNK multiple; each shard's slab stays chunk
    aligned, its scales padded with zeros."""
    q = torch.as_tensor(q, dtype=torch.int8)
    s = torch.as_tensor(scales, dtype=torch.float32)
    w = torch.as_tensor(weights, dtype=torch.float32)
    _check_chunked(q.shape[1])
    return [_comp_ops.dequant_reduce(
        _slab(q, lo, hi, hi - lo, d),
        _slab(s, lo // CHUNK, hi // CHUNK, (hi - lo) // CHUNK, d), w.to(d))
        for d, lo, hi in _split(mesh, q.shape[1], CHUNK)]


def sharded_dequant_reduce(q, scales, weights, *,
                           mesh: Mesh) -> torch.Tensor:
    """(N, T) int8 x (N, T/CHUNK) x (N,) -> (T,) f32, K3 once a shard."""
    return gather(dequant_reduce_slabs(q, scales, weights, mesh=mesh),
                   q.shape[1])


def _bits(z) -> torch.Tensor:
    """A 32-bit residue array or tensor as its int32 bit pattern."""
    if not isinstance(z, torch.Tensor):
        z = torch.from_numpy(np.require(np.asarray(z).astype(np.uint32),
                                        requirements="CW").view(np.int32))
    if z.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"not a 32-bit residue dtype: {z.dtype}")
    return z.view(torch.int32)


def sharded_masked_dequant_reduce(z, scales, *, modulus_bits: int,
                                  corr=None, mesh: Mesh) -> torch.Tensor:
    """(N, T) 32-bit residues mod 2**modulus_bits (uint32 or their int32
    bit patterns) -> (T,) f32; K4 (with or without corrections) once a
    shard. Zero columns decode to exactly 0, so each shard's modular
    decode stays bit-exact."""
    z = _bits(z)
    c = None if corr is None else _bits(corr)
    s = torch.as_tensor(scales, dtype=torch.float32)
    t = z.shape[1]
    _check_chunked(t)
    outs = []
    for d, lo, hi in _split(mesh, t, CHUNK):
        w = hi - lo
        outs.append(_comp_ops.masked_dequant_reduce(
            _slab(z, lo, hi, w, d),
            _slab(s, lo // CHUNK, hi // CHUNK, w // CHUNK, d),
            modulus_bits=int(modulus_bits),
            corr=None if c is None else _slab(c, lo, hi, w, d)))
    return gather(outs, t)
