"""Collectives and roofline terms (port of ``repro.launch.hlo_analysis``).

The reference parses the compiled per-device HLO text for its
collectives (``analyze_collectives``): every all-reduce, all-gather,
reduce-scatter, all-to-all and collective-permute, with a ring-algorithm
traffic estimate, split intra-pod (ICI) and cross-pod (DCN). The port
compiles no HLO; ``record_collectives`` is its counterpart: a
``TorchDispatchMode`` that sees every collective this rank issues while
it is on, both the ``_c10d_functional`` ops that ``DTensor`` issues when
it redistributes and explicit ``torch.distributed`` calls (the ``c10d``
ops), and sums them in the reference's keys and with the reference's
ring traffic. A collective is cross-pod when its group's ranks fall in
more than one pod (rank ``// pod_size``). It defers every op on
``DTensor``s to ``DTensor`` itself, so it sees the local collectives
that they lower to. On one card a step issues none: ``no_collectives``.

``roofline_terms`` keeps the reference's dict and ``dominant``, with the
links of a GPU cluster: intra-pod collective bytes (``ici_bytes``) go
over NVLink, cross-pod bytes (``dcn_bytes``) over the network.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# op name (either namespace) -> the reference's kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


def no_collectives() -> dict:
    """The collective summary of a one-card step, in the keys of the
    reference's ``analyze_collectives``."""
    return {"ops": [], "bytes_by_kind": {}, "ici_bytes": 0.0,
            "dcn_bytes": 0.0, "count": 0}


def ring_traffic(kind: str, res_bytes: float, gsize: int) -> float:
    """The reference's ring-algorithm bytes a device moves for one
    collective whose result is ``res_bytes`` over a group of ``gsize``."""
    g = max(gsize, 1)
    if kind == "all-reduce":
        return 2.0 * res_bytes * (gsize - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return res_bytes * (gsize - 1) / g
    if kind == "reduce-scatter":
        return float(res_bytes * (gsize - 1))   # operand = result * gsize
    return float(res_bytes)     # collective-permute; a broadcast's copy


def _bytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(obj)
               if isinstance(t, torch.Tensor))


def _group_ranks(args, kwargs) -> Optional[list]:
    """The global ranks of the op's group: a ``ProcessGroup`` argument
    (``c10d``) or a group name (``_c10d_functional``)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in tree_leaves((args, kwargs)):
        if isinstance(a, torch.ScriptObject):       # a boxed ProcessGroup
            try:
                a = dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
    for a in tree_leaves((args, kwargs)):
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(
                    _resolve_process_group(a))
            except (ValueError, RuntimeError, KeyError):
                continue
    return None


class record_collectives(TorchDispatchMode):
    """``with record_collectives(pod_size=...) as rec:`` records every
    collective this rank issues; ``rec.summary()`` is the reference's
    ``analyze_collectives`` dict (``ops`` with ``kind``, ``bytes``,
    ``group_size``, ``traffic``, ``cross_pod``, then ``bytes_by_kind``,
    ``ici_bytes``, ``dcn_bytes``, ``count``)."""

    def __init__(self, *, pod_size: Optional[int] = None):
        super().__init__()
        self.pod_size = pod_size
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        kind = _KINDS.get(func._opname) if ns in (
            "_c10d_functional", "c10d", "c10d_functional") else None
        if kind is not None:
            res = out if ns != "c10d" else args[0]
            self._note(kind, _bytes(res), _group_ranks(args, kwargs))
        return out

    def _note(self, kind: str, res_bytes: int, ranks):
        if ranks is None:
            ranks = list(range(dist.get_world_size()))
        gsize = len(ranks)
        cross = bool(self.pod_size) and len(
            {r // self.pod_size for r in ranks}) > 1
        self.ops.append({"kind": kind, "bytes": res_bytes,
                         "group_size": gsize,
                         "traffic": ring_traffic(kind, res_bytes, gsize),
                         "cross_pod": cross})

    def summary(self) -> dict:
        out = no_collectives()
        by_kind = defaultdict(float)
        for op in self.ops:
            by_kind[op["kind"]] += op["traffic"]
            out["dcn_bytes" if op["cross_pod"] else "ici_bytes"] += \
                op["traffic"]
        out.update(ops=list(self.ops), bytes_by_kind=dict(by_kind),
                   count=len(self.ops))
        return out


def roofline_terms(flops: float, hbm_bytes: float, coll: dict, hw,
                   *, n_chips: int) -> dict:
    """All quantities are per device. ``hw`` carries ``peak_flops_bf16``,
    ``hbm_bw``, ``nvlink_bw`` and ``network_bw`` (``launch.mesh.H100``)."""
    compute_t = flops / hw.peak_flops_bf16
    memory_t = hbm_bytes / hw.hbm_bw
    coll_t = (coll["ici_bytes"] / hw.nvlink_bw
              + coll["dcn_bytes"] / hw.network_bw)
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": coll_t}
    dom = max(terms, key=terms.get)
    return {**terms, "dominant": dom,
            "step_time_lower_bound_s": max(terms.values())}
