"""Dry-run variants (port of ``repro.launch.variants``).

Each variant is a named alternative build of an (arch x shape) program;
``dryrun.measure(..., variant=...)`` writes the same roofline artifact as
the baseline, so the two compare directly:

  seqpar       — sequence parallelism: ``REPRO_SEQ_SHARD=1`` constrains
                 the residual stream to (batch: data, seq: model) between
                 blocks (``models/transformer.py::_seq_shard``).
  tree_decode  — ``REPRO_TREE_DECODE=1`` keeps a decode step's scores
                 sharded on the KV-sequence dim over ``"data"``
                 (``models/attention.py``).
  ssm_shard    — ``REPRO_SSM_SHARD=1`` places the SSM heads over
                 ``"model"`` and replicates B and C
                 (``models/ssm.py::_ssm_shard``).
  moe_grouped  — the MoE dispatch in 16 token groups
                 (``REPRO_MOE_GROUPED=16``, ``models/moe.py``).
  fedavg_sync  — the paper's Model Aggregator, the f32 mean over the silo
                 dim of ``N_PODS`` silo-stacked replicas
                 (``make_fedavg_pod_step``); over a mesh with ``"pod"`` an
                 all-reduce over the pod group.
  fedavg_q8    — its int8 variant: each silo's leaf quantized with one
                 scale; over a mesh, the max all-reduced over (data,
                 model) and the int8 values and scales all-gathered over
                 ``"pod"``, as the reference's ``shard_map``.

The flags are set around each call, as the port reads them at call time
(the reference sets them around ``.lower()``). The three mesh-only hooks
are sharding constraints (``sharding.specs.constrain``) that read the
mesh in scope, so on one card they are the identity and the variant is
the baseline program.
"""
from __future__ import annotations

import os

from repro_torch import tree as _tree
from repro_torch.configs import get_config
from repro_torch.sharding import param_pspecs
from repro_torch.training import make_fedavg_pod_step

N_PODS = 2

_ENV_VARIANTS = {
    # variant -> (env flag read at call time, value)
    "seqpar": ("REPRO_SEQ_SHARD", "1"),
    "tree_decode": ("REPRO_TREE_DECODE", "1"),
    "moe_grouped": ("REPRO_MOE_GROUPED", "16"),
    "ssm_shard": ("REPRO_SSM_SHARD", "1"),
}
_FEDAVG = ("fedavg_sync", "fedavg_q8")


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
                  mesh=None, model=None):
    """``(mesh, fn, args)`` of ``variant``, as ``dryrun.build_dryrun``
    returns them (``mesh`` / ``multi_pod`` as there). ``model``: the
    arch's meta model, when the caller has built it."""
    from repro_torch.launch import dryrun

    if variant not in _ENV_VARIANTS and variant not in _FEDAVG:
        raise ValueError(f"unknown variant {variant!r}")
    mesh = dryrun._resolve_mesh(mesh, multi_pod=multi_pod)
    if model is None:
        cfg = get_config(arch) if isinstance(arch, str) else arch
        model = dryrun._meta_model(cfg)
    if variant in _ENV_VARIANTS:
        env, value = _ENV_VARIANTS[variant]
        fn, args = dryrun._build(model, dryrun._shape(shape), mesh)
        return mesh, _EnvCall(fn, env, value), args
    return (mesh,) + _build_fedavg(model, mesh,
                                   quantize=(variant == "fedavg_q8"))


def _build_fedavg(model, mesh, *, quantize: bool):
    """The cross-silo Model Aggregator over ``N_PODS`` stacked replicas of
    ``model``'s meta masters: ``(fn, args)``. Over a mesh of ranks the
    replicas are placed ``P("pod", *param_pspecs)``, as the reference's."""
    params = model.abstract_params()
    stacked = _tree.tree_map(
        lambda a: a[None].expand((N_PODS,) + a.shape).contiguous(), params)
    if mesh.device_mesh is None:
        return make_fedavg_pod_step(quantize=quantize), (stacked,)
    if "pod" not in mesh.axis_names:
        raise ValueError("the FedAvg variants exchange silos over a 'pod' "
                         f"axis, which {mesh} lacks (use --multi-pod)")
    from repro_torch.launch.dryrun import _on_mesh, _placed, _prefix_pod
    specs = _prefix_pod(param_pspecs(params, mesh))
    step = make_fedavg_pod_step(quantize=quantize, pspecs=specs)
    return _on_mesh(step, mesh), (_placed(stacked, specs, mesh),)
