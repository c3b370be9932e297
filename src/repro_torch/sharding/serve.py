"""Serve-mode placements over ranks: what XLA's partitioner chooses for
the reference's prefill and decode, chosen by hand.

A serve program (``Model.prefill``, ``Model.decode_step``) over a mesh of
ranks runs each attention and SSM layer head-parallel over "model". This
rank takes an even span of the heads (``span``: DTensor's chunk rule,
ceil(n / size) a rank and the last ranks fewer or none, as XLA pads an
uneven split), computes its queries from its own columns of the
projection and attends on plain local tensors; its share of the output
projection is a partial sum over "model", which the residual stream
reduces. Keys and values, and the SSM's inputs shared by every head, are
gathered whole over "model" once a layer, so that any span of q heads
finds its kv heads and a cache leaf takes its shard of them with no
collective. No collective depends on the span, so a rank with no heads
still issues every one its peers do.

A train program keeps the placements DTensor propagates from
``sharding/specs.py``'s rules: there they hold the reference's peak and
bytes already, and autograd needs no local blocks.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.sharding.specs import contiguous_stride

MODEL = "model"


def model_dim(t) -> Optional[int]:
    """The index of the "model" dim of ``t``'s mesh: None for a plain
    tensor or a mesh without one."""
    if not isinstance(t, DTensor):
        return None
    names = tuple(t.device_mesh.mesh_dim_names or ())
    return names.index(MODEL) if MODEL in names else None


def over_ranks(t) -> bool:
    """``t`` is a ``DTensor`` on a mesh with a "model" axis."""
    return model_dim(t) is not None


def span(n: int, like: DTensor) -> Tuple[int, int]:
    """This rank's ``[lo, hi)`` of ``n`` heads over "model" of ``like``'s
    mesh: ceil(n / size) a rank, in rank order (DTensor's ``Shard``
    chunks), the last ranks fewer or none."""
    mesh, i = like.device_mesh, model_dim(like)
    size, r = mesh.size(i), mesh.get_local_rank(i)
    c = -(-n // size)
    lo = min(r * c, n)
    return lo, min(lo + c, n)


def rows_placement(t: DTensor) -> list:
    """``t``'s placements with only its batch dim (dim 0) kept sharded,
    over mesh dims other than "model": every other dim whole
    (``Replicate``), and everything whole over "model"."""
    m = model_dim(t)
    return [p if isinstance(p, Shard) and p.dim == 0 and i != m
            else Replicate() for i, p in enumerate(t.placements)]


def batch_only(x):
    """``x`` redistributed so that only its batch dim stays sharded (a
    gather of the dims it splits, a reduction where it is partial); a
    plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = rows_placement(x)
    return x if list(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)


def whole(t) -> torch.Tensor:
    """``t``'s local block with only its batch dim sharded: every other dim
    whole on this rank."""
    return batch_only(t).to_local() if isinstance(t, DTensor) else t


def full(w) -> torch.Tensor:
    """A weight whole on this rank (gathered where it is split)."""
    return w.full_tensor() if isinstance(w, DTensor) else w


def local_rows(a, like: DTensor) -> torch.Tensor:
    """The rows of ``a`` (a plain tensor every rank holds whole, or a
    ``DTensor``) that this rank's block of ``like`` holds."""
    pl = rows_placement(like)
    if isinstance(a, DTensor):
        return a.redistribute(like.device_mesh, pl).to_local()
    return distribute_tensor(a, like.device_mesh, pl,
                             src_data_rank=None).to_local()


def _global(local: torch.Tensor, like: DTensor, dims: dict) -> tuple:
    """The global shape of a block of ``local`` whose dim 0 follows
    ``like``'s batch and whose dims in ``dims`` have the given sizes."""
    shape = list(local.shape)
    shape[0] = like.shape[0]
    for d, n in dims.items():
        shape[d] = n
    return tuple(shape)


def _wrap(local, like, placements, dims=None) -> DTensor:
    shape = _global(local, like, dims or {})
    return DTensor.from_local(local, like.device_mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def partial(local: torch.Tensor, like: DTensor) -> DTensor:
    """This rank's share of a sum over "model" as a ``DTensor``
    (``Partial``), placed on the batch as ``like``."""
    pl = rows_placement(like)
    pl[model_dim(like)] = Partial()
    return _wrap(local, like, pl)


def replicated(local: torch.Tensor, like: DTensor) -> DTensor:
    """A tensor every rank of a "model" group holds whole, as a
    ``DTensor`` placed on the batch as ``like``."""
    return _wrap(local, like, rows_placement(like))


def heads(local: torch.Tensor, like: DTensor, dim: int, n: int) -> DTensor:
    """This rank's ``span`` of ``n`` heads on ``dim`` of ``local`` as a
    ``DTensor`` sharded there over "model", on the batch as ``like``."""
    pl = rows_placement(like)
    pl[model_dim(like)] = Shard(dim)
    return _wrap(local, like, pl, {dim: n})


def reduced(local: torch.Tensor, like: DTensor) -> torch.Tensor:
    """The sum over "model" of every rank's ``local`` (an all-reduce)."""
    return whole(partial(local, like))


def head_block(w, dim: int, n: int, unit: int, like: DTensor) -> torch.Tensor:
    """This rank's ``span`` of ``n`` heads of ``unit`` entries each along
    ``dim`` of the weight ``w``, as a local plain tensor whole along every
    other dim: its own shard when ``w`` is split over "model" along
    ``dim`` at the heads' boundaries, else ``w`` gathered whole (a serving
    weight is small beside the activations it meets). The choice reads
    global shapes only, so every rank of a group makes it alike."""
    lo, hi = span(n, like)
    if isinstance(w, DTensor):
        size = like.device_mesh.size(model_dim(like))
        own = [Shard(dim) if i == model_dim(like) else Replicate()
               for i in range(len(w.placements))]
        if (list(w.placements) == own and n % size == 0
                and w.shape[dim] == n * unit):
            return w.to_local()
        w = w.full_tensor()
    return w.narrow(dim, lo * unit, (hi - lo) * unit)


def sections(w, dim: int, ranges: Sequence[Tuple[int, int]]) -> list:
    """``w``'s ``[lo, hi)`` along ``dim`` for each range, from ``w``
    gathered whole once, as local plain tensors."""
    if isinstance(w, DTensor):
        w = w.full_tensor()
    return [w.narrow(dim, lo, hi - lo) for lo, hi in ranges]


def local_block(t: DTensor, placements=None) -> Tuple[tuple, tuple]:
    """``(shape, offset)`` of this rank's block of ``t`` (placed as
    ``placements``, by default as it is)."""
    shape, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh,
        t.placements if placements is None else placements)
    return tuple(shape), tuple(off)


def is_model_rank0(like: DTensor) -> bool:
    """This rank is the first of its "model" group."""
    return like.device_mesh.get_local_rank(model_dim(like)) == 0
