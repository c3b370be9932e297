"""Roofline terms from FLOP, byte and collective counts (port of
``repro.launch.hlo_analysis``).

The reference parses the compiled per-device HLO text for its
collectives (``analyze_collectives``): every all-reduce, all-gather,
reduce-scatter, all-to-all and collective-permute, with a ring-algorithm
traffic estimate, split intra-pod (ICI) and cross-pod (DCN). The port
compiles no HLO, so there is nothing to parse. Its counterpart, the
collectives recorded from the ``torch.distributed`` ops a step issues,
waits for the placement over four cards (``ROADMAP.md``). On one card a
step issues no collective, so ``no_collectives`` is the summary the dry
run passes on: all zeros by construction, in the reference's keys.

``roofline_terms`` keeps the reference's dict and ``dominant``, with the
links of a GPU node: intra-node collective bytes (``ici_bytes``) go over
NVLink, cross-node bytes (``dcn_bytes``) over the node's network.
"""
from __future__ import annotations


def no_collectives() -> dict:
    """The collective summary of a one-card step, in the keys of the
    reference's ``analyze_collectives``."""
    return {"ops": [], "bytes_by_kind": {}, "ici_bytes": 0.0,
            "dcn_bytes": 0.0, "count": 0}


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
