"""Dry-run variants (port of ``repro.launch.variants``).

Each variant is a named alternative build of an (arch x shape) program;
``dryrun.measure(..., variant=...)`` writes the same roofline artifact as
the baseline, so the two compare directly. On one card:

  moe_grouped  — the MoE dispatch in 16 token groups: ``REPRO_MOE_GROUPED
                 =16`` is set around the call (``models/moe.py`` reads it
                 at call time).
  fedavg_sync  — the paper's Model Aggregator, the f32 mean over the silo
                 dim of two silo-stacked replicas (``make_fedavg_pod_step``).
  fedavg_q8    — its int8 variant: each silo's leaf quantized to int8 with
                 one scale, dequantized, then the f32 mean.

The reference's ``seqpar``, ``tree_decode`` and ``ssm_shard`` are
sharding constraints over a TPU mesh's axes (the sequence, the KV cache
and the SSM heads over ``"model"`` or ``"data"``); one card has no axis
to shard over, so they raise ``NotImplementedError`` until the four-card
placement exists. Its ``fedavg_*`` exchange the silos over the ``"pod"``
axis; here both replicas sit on the one card.
"""
from __future__ import annotations

import os

from repro_torch import tree as _tree
from repro_torch.configs import get_config
from repro_torch.training import make_fedavg_pod_step

N_PODS = 2

_ENV_VARIANTS = {
    # variant -> (env flag read at call time, value)
    "moe_grouped": ("REPRO_MOE_GROUPED", "16"),
}
_FEDAVG = ("fedavg_sync", "fedavg_q8")
_MESH_ONLY = ("seqpar", "tree_decode", "ssm_shard")


class _EnvCall:
    """Sets an env flag for the duration of each call of ``fn``."""

    def __init__(self, fn, env: str, value: str):
        self._fn, self._env, self._value = fn, env, value

    def __call__(self, *args, **kw):
        old = os.environ.get(self._env)
        os.environ[self._env] = self._value
        try:
            return self._fn(*args, **kw)
        finally:
            if old is None:
                os.environ.pop(self._env, None)
            else:
                os.environ[self._env] = old


def build_variant(arch, shape, variant: str, *, multi_pod: bool = False,
                  model=None):
    """``(mesh, fn, args)`` of ``variant``, as ``dryrun.build_dryrun``
    returns them. ``model``: the arch's meta model, when the caller has
    built it."""
    from repro_torch.launch import dryrun

    if variant in _MESH_ONLY:
        raise NotImplementedError(
            f"variant {variant!r} is a sharding constraint over a mesh's "
            "axes; one card has none (it waits for the four-card "
            "placement, ROADMAP.md)")
    if variant not in _ENV_VARIANTS and variant not in _FEDAVG:
        raise ValueError(f"unknown variant {variant!r}")
    mesh = dryrun._card_mesh(multi_pod=multi_pod)
    if model is None:
        cfg = get_config(arch) if isinstance(arch, str) else arch
        model = dryrun._meta_model(cfg)
    if variant in _ENV_VARIANTS:
        env, value = _ENV_VARIANTS[variant]
        fn, args = dryrun._step(model, dryrun._shape(shape))
        return mesh, _EnvCall(fn, env, value), args
    return (mesh,) + _build_fedavg(model, quantize=(variant == "fedavg_q8"))


def _build_fedavg(model, *, quantize: bool):
    """The cross-silo Model Aggregator over ``N_PODS`` stacked replicas of
    ``model``'s meta masters: ``(fn, args)``."""
    stacked = _tree.tree_map(
        lambda a: a[None].expand((N_PODS,) + a.shape).contiguous(),
        model.abstract_params())
    return make_fedavg_pod_step(quantize=quantize), (stacked,)
