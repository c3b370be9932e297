"""Analytic HBM-traffic model for the memory roofline term (port of
``repro.launch.roofline_model``).

The same hand-roofline accounting as the reference, over the meta trees
of ``Model.abstract_params`` and ``abstract_cache`` (``element_size()``
where the reference reads ``np.dtype(...).itemsize``), so the results
equal the reference's float for float. The dry run's live-bytes tracker
(``launch/dryrun.py``) records the program's own peak beside it; the
memory term stays the analytic one, as in the reference.

All results are **per device** on the given mesh.
"""
from __future__ import annotations

from repro_torch import tree as _tree


def _n_params(model) -> int:
    return sum(leaf.numel() for leaf in _tree.leaves(model.abstract_params()))


def traffic_bytes(model, shape, *, n_devices: int, dp: int, tp: int) -> dict:
    """Per-device HBM bytes for one step of ``shape.mode``.

    Accounting (bytes; params stored fp32, activations bf16):
      train:   params fwd read + bwd read (4B each, FSDP-sharded)
               + AdamW m/v/param read+write (5 x 4B)
               + grad write+read (2 x 4B)
               + remat activation save/reload/recompute (3 passes over the
                 per-layer carry, L*B*S*D*2B each)
               + qkv/context recompute traffic (2 passes)
               + CE logits (chunked: 2 passes over B*S*V_shard*2B)
      prefill: params read + 4 activation passes + KV-cache write
      decode:  params read + full KV-cache read + O(1) writes
    """
    cfg = model.cfg
    n_par = _n_params(model)
    P4 = 4.0 * n_par / n_devices                 # fp32 param shard bytes
    B = shape.global_batch
    S = shape.seq_len
    D = cfg.d_model
    L = cfg.n_layers + cfg.n_encoder_layers
    B_loc = max(B // dp, 1)
    act2 = 2.0                                    # bf16 activation bytes
    carry = L * B_loc * S * D * act2
    V_shard = cfg.vocab / tp

    if shape.mode == "train":
        params_t = P4 * (2 + 5 + 2)
        acts_t = carry * 3 + carry * 2
        ce_t = 2 * B_loc * S * V_shard * act2
        total = params_t + acts_t + ce_t
        detail = {"params_opt": params_t, "activations": acts_t,
                  "cross_entropy": ce_t}
    elif shape.mode == "prefill":
        P2 = 2.0 * n_par / n_devices      # serving uses bf16 weights
        cache_b = _cache_bytes(model, shape, n_devices)
        acts_t = carry * 4
        total = P2 + acts_t + cache_b
        detail = {"params": P2, "activations": acts_t, "cache_write": cache_b}
    else:  # decode
        P2 = 2.0 * n_par / n_devices
        cache_b = _cache_bytes(model, shape, n_devices)
        total = P2 + cache_b
        detail = {"params": P2, "cache_read": cache_b}
    return {"total": total, "detail": detail}


def _cache_bytes(model, shape, n_devices: int) -> float:
    cache = model.abstract_cache(shape.global_batch,
                                 model.cache_len_for(shape.seq_len))
    tot = sum(leaf.numel() * leaf.element_size()
              for leaf in _tree.leaves(cache))
    return tot / n_devices
