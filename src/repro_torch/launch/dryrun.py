"""Dry run: build each (arch x input shape) step on meta tensors and read
its FLOPs, bytes, collectives and roofline terms (port of
``repro.launch.dryrun``), over one H100 or over a mesh of H100s.

The reference lowers and compiles each program for a TPU mesh and reads
XLA's cost and memory analyses and the collectives of the per-device
HLO. The port runs the same step, the one its entry points run
(``make_train_step`` with AdamW on a model at ``remat=True`` unless the
caller asks otherwise, or ``Model.prefill`` / ``decode_step`` on bf16
weights, ``impl="xla"``), on the ``meta`` device, where every
tensor has a shape and a dtype and no storage, so it needs no card and
allocates nothing:

* ``LocalFlops`` counts the FLOPs of every matmul-class op (2·M·N·K a
  product, ``FlopCounterMode``'s formulas), in every layer and every
  chunk: Python loops run each one, so there is no depth extrapolation
  (the reference's ``_cost_pass`` and ``_scale_coll``) and no cost mode
  (the reference re-lowers with ``REPRO_COST_MODE=1`` because XLA counts
  a loop body once whatever its trip count). Elementwise work is not
  counted; it belongs to the memory term, which is the analytic
  ``roofline_model.traffic_bytes``, as in the reference.
* ``LiveBytes`` adds each new output storage's bytes to a live count and
  subtracts them when the storage is freed; its peak is ``temp_bytes``
  (the step's outputs included).

Over a mesh (``--mesh production``: the reference's (16, 16) and, with
``--multi-pod``, (2, 16, 16); or small sizes such as ``2,4`` /
``2,2,2``) the step runs as rank 0 of the ``fake`` process group
(``fake_world``) at 256 or 512 ranks: every leaf is a ``DTensor`` placed
by the reference's rules (train FSDP x TP, serve TP only on bf16
weights, caches by ``cache_pspecs``, the batch over ``"data"``); the
multi-pod program stacks a silo dim over ``"pod"`` and halves each pod's
batch, as the reference's ``vmap(spmd_axis_name="pod")`` does
(``training.steps.pod_map``). Every collective returns at once, so
nothing needs a card. The three modes defer each ``DTensor`` op to
``DTensor`` and see the local ops it runs, so FLOPs and bytes are rank
0's share (a ``FlopCounterMode`` around the program would count the
global op), and ``hlo_analysis.record_collectives`` records the
collectives rank 0 issues, intra-pod over NVLink and cross-pod (pod size
256, one NVLink domain of a DGX H100 SuperPOD) over the network.

The artifact has the reference's keys, so ``benchmarks/roofline.py``'s
``roofline_table(..., mesh=...)`` reads it unchanged (meshes ``h100x1``,
``h100x16x16``, ``h100x2x16x16``). The keys that have no counterpart are
null: ``xla_bytes_accessed_rolled``, ``collectives.rolled_count`` and
``cost_compile_s``. ``compile_s`` is the seconds of the meta run.
``peak_bytes`` is ``argument_bytes + temp_bytes``: the step's arguments
stay alive beside everything it allocates (nothing is donated).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # one card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh production
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh production \\
      --multi-pod
Artifacts land in
artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__variant].json.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import time
import weakref
from functools import partial

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as _tree
from repro_torch.configs import (SHAPES, get_config, get_shape,
                                 list_configs, shape_applicable)
from repro_torch.launch.hlo_analysis import (record_collectives,
                                             roofline_terms)
from repro_torch.launch.mesh import (H100, PRODUCTION_SHAPES, Mesh,
                                     init_ranks, make_card_mesh,
                                     make_production_mesh, mesh_name,
                                     rank_mesh)
from repro_torch.launch.roofline_model import _n_params, traffic_bytes
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.sharding import cache_pspecs, param_pspecs
from repro_torch.sharding.mesh import (current_mesh, mesh_scope,
                                       sharded_program)
from repro_torch.sharding.specs import P, NamedSharding, constrain
from repro_torch.training import make_multipod_train_step, make_train_step
from repro_torch.training.steps import pod_map

OUT_DIR = "artifacts/dryrun_torch"
N_PODS = 2


@contextlib.contextmanager
def fake_world(world: int):
    """Rank 0 of a ``fake`` process group of ``world`` ranks for the
    duration: every collective returns at once, nothing needs a card.
    Torn down on exit."""
    init_ranks("fake", world, 0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def parse_mesh(text, *, multi_pod: bool = False):
    """``--mesh``: ``card`` (one H100; with ``multi_pod`` the production
    mesh, as the reference's ``--multi-pod``), ``production`` (the
    reference's (16, 16), or (2, 16, 16) with ``multi_pod``), or axis
    sizes ``data,model`` / ``pod,data,model``. Returns ``(sizes, names)``,
    or None for one card."""
    if text in (None, "card"):
        if not multi_pod:
            return None
        text = "production"
    if text == "production":
        return PRODUCTION_SHAPES[bool(multi_pod)]
    sizes = tuple(int(n) for n in str(text).split(","))
    if len(sizes) == 3:
        return sizes, ("pod", "data", "model")
    if len(sizes) == 2 and not multi_pod:
        return sizes, ("data", "model")
    raise ValueError(f"--mesh {text!r}: data,model or pod,data,model")


def _resolve_mesh(mesh=None, *, multi_pod: bool = False) -> Mesh:
    """The dry run's mesh: one card (default), or a mesh over the
    initialised group's ranks (``fake_world``): ``mesh`` itself, its
    shape over the ranks, or with ``multi_pod`` the production mesh."""
    if mesh is None and not multi_pod:
        return make_card_mesh()
    if mesh is not None and mesh.device_mesh is not None:
        return mesh
    if mesh is not None and mesh.size == 1:
        return mesh
    if not dist.is_initialized():
        what = "the multi-pod mesh" if mesh is None else repr(mesh)
        raise ValueError(f"{what} needs ranks: run it inside "
                         "fake_world(<its size>)")
    if mesh is None:
        return make_production_mesh(multi_pod=True)
    return rank_mesh(mesh.axis_sizes, mesh.axis_names)


def _shape(shape):
    return get_shape(shape) if isinstance(shape, str) else shape


def _serve_params(model) -> dict:
    """The meta masters cast to bf16: the serving weights."""
    return _tree.tree_map(
        lambda a: a.to(torch.bfloat16) if a.dtype == torch.float32 else a,
        model.abstract_params())


def build_dryrun(arch, shape, *, multi_pod: bool = False, mesh=None,
                 remat: bool = True):
    """Returns ``(mesh, fn, args)``: ``fn(*args)`` runs one step of
    ``shape.mode`` on meta tensors.

    ``arch`` is a registry name or a ``ModelConfig``; ``shape`` a name of
    ``SHAPES`` or an ``InputShape``. A train shape runs
    ``make_train_step(model, adamw(1e-4))`` on the fp32 masters and
    ``opt.init`` of them; a prefill runs ``model.prefill`` on the bf16
    weights with ``cache_len_for(seq_len)`` slots; a decode runs
    ``model.decode_step`` on ``input_specs``' cache, token and position.
    ``mesh`` (a ``Mesh``) or ``multi_pod`` put the step on a mesh of
    ranks (``_resolve_mesh``); with neither it is one card. ``remat``
    is the model's (``Model``).
    """
    mesh = _resolve_mesh(mesh, multi_pod=multi_pod)
    cfg = get_config(arch) if isinstance(arch, str) else arch
    return (mesh,) + _build(_meta_model(cfg, remat), _shape(shape), mesh)


def _build(model, shape, mesh):
    """``(fn, args)`` of the step on one card or on a mesh of ranks."""
    if mesh.device_mesh is None:
        return _step(model, shape)
    return _sharded_step(model, shape, mesh)


def _meta_model(cfg, remat: bool = True):
    """``cfg``'s model on meta, whose ``abstract_params`` tree is built
    once (seconds for the large configs) and shared by the step, the
    traffic model and the FLOP estimate."""
    model = build_model(cfg, impl="xla", remat=remat, device="meta")
    model.abstract_params = functools.cache(model.abstract_params)
    return model


def _step(model, shape):
    """``(fn, args)`` of one step of ``shape.mode`` on ``model``'s meta
    trees."""
    if shape.mode == "train":
        opt = adamw(1e-4)
        params = model.abstract_params()
        return make_train_step(model, opt), (
            params, opt.init(params), model.input_specs(shape))
    params = _serve_params(model)
    if shape.mode == "prefill":
        fn = partial(model.prefill,
                     cache_len=model.cache_len_for(shape.seq_len))
        return fn, (params, model.input_specs(shape))
    specs = model.input_specs(shape)            # {"cache", "token", "pos"}
    return model.decode_step, (params, specs["cache"], specs["token"],
                               specs["pos"])


def _placed(tree, specs, mesh):
    """Meta ``tree`` as ``DTensor``s placed by ``specs`` on ``mesh``."""
    return _tree.tree_map(lambda a, s: NamedSharding(mesh, s).place(a),
                          tree, specs)


def _stacked(tree, n: int):
    """Meta leaves with a leading silo dim of ``n``."""
    return _tree.tree_map(
        lambda a: torch.empty((n,) + tuple(a.shape), dtype=a.dtype,
                              device=a.device), tree)


def _prefix_pod(specs):
    return _tree.tree_map(lambda s: P("pod", *s), specs)


def _batch_specs(batch, pods: bool):
    """The batch over ``"data"`` (after ``"pod"`` on the silo dim)."""
    lead = ("pod", "data") if pods else ("data",)
    return _tree.tree_map(
        lambda a: P(*lead, *([None] * (a.dim() - len(lead)))), batch)


def _pod_batch(batch, n: int):
    """(B, ...) meta leaves as (n, B // n, ...): each pod's share."""
    return _tree.tree_map(
        lambda a: torch.empty((n, a.shape[0] // n) + tuple(a.shape[1:]),
                              dtype=a.dtype, device=a.device), batch)


def _with_cache_specs(fn, batch: int):
    """``fn`` whose returned cache (the last of its outputs) is placed by
    ``cache_pspecs`` on the mesh in scope: the reference's
    ``out_shardings`` of the cache."""
    def placed(*args):
        out, cache = fn(*args)
        specs = cache_pspecs(cache, current_mesh(), batch=batch)
        return out, _tree.tree_map(lambda c, s: constrain(c, s), cache,
                                   specs)
    return placed


def _on_mesh(fn, mesh):
    """``fn`` run inside ``mesh_scope(mesh)`` with plain tensors counting
    as replicated: the reference's ``with mesh:`` around the jitted
    step."""
    def run(*args):
        with mesh_scope(mesh), sharded_program(tree_leaves(args)):
            return fn(*args)
    return run


def _sharded_step(model, shape, mesh):
    """``(fn, args)`` of one step of ``shape.mode`` on a mesh of ranks, the
    reference's ``build_dryrun`` placements: train FSDP x TP, serve TP
    only on bf16 weights, caches by ``cache_pspecs``, the batch over
    ``"data"``; a ``"pod"`` axis stacks ``N_PODS`` silos over it and
    halves each pod's batch (a decode serves B requests a pod)."""
    pods = "pod" in mesh.axis_names
    B = shape.global_batch
    if shape.mode == "train":
        opt = adamw(1e-4)
        params = model.abstract_params()
        p_specs = param_pspecs(params, mesh)
        batch = model.input_specs(shape)
        if pods:
            params, p_specs = _stacked(params, N_PODS), _prefix_pod(p_specs)
            batch = _pod_batch(batch, N_PODS)
            step = make_multipod_train_step(model, opt, N_PODS)
        else:
            step = make_train_step(model, opt)
        params = _placed(params, p_specs, mesh)
        batch = _placed(batch, _batch_specs(batch, pods), mesh)
        return _on_mesh(step, mesh), (params, opt.init(params), batch)

    params = _serve_params(model)
    p_specs = param_pspecs(params, mesh, mode="serve")
    if pods:
        params, p_specs = _stacked(params, N_PODS), _prefix_pod(p_specs)
    params = _placed(params, p_specs, mesh)
    if shape.mode == "prefill":
        Bp = B // N_PODS if pods else B
        fn = _with_cache_specs(
            partial(model.prefill,
                    cache_len=model.cache_len_for(shape.seq_len)), Bp)
        batch = model.input_specs(shape)
        if pods:
            batch, fn = _pod_batch(batch, N_PODS), pod_map(fn)
        batch = _placed(batch, _batch_specs(batch, pods), mesh)
        return _on_mesh(fn, mesh), (params, batch)

    specs = model.input_specs(shape)            # {"cache", "token", "pos"}
    cache, token, pos = specs["cache"], specs["token"], specs["pos"]
    c_specs = cache_pspecs(cache, mesh, batch=B)
    lead = ("data",) if B % mesh.shape["data"] == 0 else (None,)
    fn = _with_cache_specs(model.decode_step, B)
    if pods:
        cache, token, pos = (_stacked(t, N_PODS) for t in (cache, token, pos))
        c_specs, lead = _prefix_pod(c_specs), ("pod",) + lead
        fn = pod_map(fn)
    t_spec = P(*lead, None)
    cache = _placed(cache, c_specs, mesh)
    token = NamedSharding(mesh, t_spec).place(token)
    pos = NamedSharding(mesh, t_spec).place(pos)
    return _on_mesh(fn, mesh), (params, cache, token, pos)


def _defers(types) -> bool:
    """A ``DTensor`` op: a mode hands it to ``DTensor``, whose local ops
    (this rank's share) then come back to the mode."""
    return any(issubclass(t, DTensor) for t in types)


def _is_fake(*objs) -> bool:
    """Ops on ``FakeTensor``s: ``DTensor``'s own shape propagation, not
    the program's work."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in tree_leaves(objs))


class LocalFlops(TorchDispatchMode):
    """FLOPs of the matmul-class ops this rank runs, by
    ``FlopCounterMode``'s formulas: a ``DTensor`` op is counted in the
    local ops it lowers to (rank 0's share), not at its global shape."""

    def __init__(self):
        super().__init__()
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _defers(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry and not _is_fake(args, kwargs, out):
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        return out


class LiveBytes(TorchDispatchMode):
    """Live bytes of the storages the ops under this mode allocate.

    An op output whose storage is new (not one of the op's inputs', not
    one already counted) adds its bytes; each tensor that holds a counted
    storage is watched, and when the last of them is freed the bytes go.
    A tensor's Python object lives as long as its C++ tensor (autograd's
    saved tensors included), so the count follows what the program keeps.
    Works alike on meta and on real tensors; a ``DTensor`` op counts the
    local storages it makes on this rank."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._bytes: dict = {}      # storage key -> bytes
        self._holders: dict = {}    # storage key -> live watched tensors

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _defers(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if _is_fake(out):
            return out
        inputs = None
        for t in _flat(out):
            key = t.untyped_storage()._cdata
            if key not in self._bytes:
                if inputs is None:
                    inputs = {a.untyped_storage()._cdata
                              for a in _flat((args, kwargs))}
                if key in inputs:
                    continue
                self._bytes[key] = t.untyped_storage().nbytes()
                self._holders[key] = 0
                self.live += self._bytes[key]
                self.peak = max(self.peak, self.live)
            self._holders[key] += 1
            weakref.finalize(t, self._release, key).atexit = False
        return out

    def _release(self, key):
        self._holders[key] -= 1
        if not self._holders[key]:
            del self._holders[key]
            self.live -= self._bytes.pop(key)


def _flat(obj):
    """The tensors of nested tuples, lists and dicts; a ``DTensor`` as its
    local shard."""
    if isinstance(obj, DTensor):
        yield obj.to_local()
    elif isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _flat(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _flat(x)


def count(fn, args, *, pod_size=None) -> dict:
    """Run ``fn(*args)`` under ``LocalFlops``, ``LiveBytes`` and
    ``record_collectives``: ``{"flops", "argument_bytes", "output_bytes",
    "temp_bytes", "collectives"}``, all this rank's."""
    arg_st = _storages_of(args)
    with LocalFlops() as fc, LiveBytes() as live, \
            record_collectives(pod_size=pod_size) as coll:
        out = fn(*args)
    out_st = {k: n for k, n in _storages_of(out).items() if k not in arg_st}
    return {"flops": fc.flops,
            "argument_bytes": sum(arg_st.values()),
            "output_bytes": sum(out_st.values()), "temp_bytes": live.peak,
            "collectives": coll.summary()}


def _storages_of(obj) -> dict:
    """{storage key: bytes} over the tensors of ``obj``, each storage
    once."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in _flat(obj)}


def model_flops_estimate(cfg, shape, *, model=None):
    """6*N*D (dense) / 6*N_active*D (MoE) useful-compute yardstick;
    returns ``(flops, n_params)``. ``model``: ``cfg``'s meta model, when
    the caller has built it."""
    model = _meta_model(cfg) if model is None else model
    n_params = _n_params(model)
    if cfg.moe is not None:
        per_expert = cfg.d_model * cfg.moe.d_expert * 3
        inactive = (cfg.moe.num_experts - cfg.moe.top_k) * per_expert \
            * cfg.n_layers
        n_active = n_params - inactive
    else:
        n_active = n_params
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    mult = 6.0 if shape.mode == "train" else 2.0
    return mult * n_active * tokens, n_params


def measure(arch, shape, *, variant: str = "baseline", mesh=None,
            multi_pod: bool = False, remat: bool = True) -> dict:
    """The artifact record of one (arch, shape[, variant]); ``arch`` a
    name or a ``ModelConfig``, ``shape`` a name or an ``InputShape``
    (chip_smoke.py passes the shapes it times). On one card unless
    ``mesh`` / ``multi_pod`` name a mesh of ranks (``_resolve_mesh``).
    ``remat`` is the model's (``Model``)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = _shape(shape)
    t0 = time.time()
    model = _meta_model(cfg, remat)
    if variant == "baseline":
        mesh = _resolve_mesh(mesh, multi_pod=multi_pod)
        fn, args = _build(model, shape, mesh)
    else:
        from repro_torch.launch import variants
        mesh, fn, args = variants.build_variant(
            cfg, shape, variant, multi_pod=multi_pod, mesh=mesh, model=model)
    # the ranks of one pod: 256 on the production mesh, one NVLink Switch
    # System domain of H100s (a DGX H100 SuperPOD); collectives whose group
    # spans two pods go over the network
    pod_size = mesh.size // mesh.shape["pod"] if "pod" in mesh.axis_names \
        else None
    counts = count(fn, args, pod_size=pod_size)
    run_s = time.time() - t0
    n_dev = mesh.size
    flops = float(counts["flops"])
    traffic = traffic_bytes(model, shape, n_devices=n_dev,
                            dp=mesh.shape.get("data", 1)
                            * mesh.shape.get("pod", 1),
                            tp=mesh.shape.get("model", 1))
    coll = counts["collectives"]
    terms = roofline_terms(flops, traffic["total"], coll, H100,
                           n_chips=n_dev)
    mf, n_params = model_flops_estimate(cfg, shape, model=model)
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name(mesh),
        "variant": variant, "status": "ok",
        "n_devices": n_dev,
        "compile_s": round(run_s, 2),
        "cost_compile_s": None,
        "n_params": int(n_params),
        "per_device": {
            "flops": flops,
            "hbm_traffic_bytes": traffic["total"],
            "hbm_traffic_detail": traffic["detail"],
            "xla_bytes_accessed_rolled": None,
            "argument_bytes": counts["argument_bytes"],
            "output_bytes": counts["output_bytes"],
            "temp_bytes": counts["temp_bytes"],
            "peak_bytes": counts["argument_bytes"] + counts["temp_bytes"],
        },
        "collectives": {
            "count": coll["count"],
            "bytes_by_kind": coll["bytes_by_kind"],
            "ici_bytes": coll["ici_bytes"],
            "dcn_bytes": coll["dcn_bytes"],
            "rolled_count": None,
        },
        "roofline": terms,
        "model_flops_total": mf,
        "useful_flops_ratio": (mf / (flops * n_dev)) if flops else None,
    }


def _tag(arch: str, shape_name: str, variant: str, name: str) -> str:
    return f"{arch}__{shape_name}__{name}" + (
        "" if variant == "baseline" else f"__{variant}")


def _sized_mesh(spec) -> Mesh:
    """``parse_mesh``'s ``(sizes, names)`` (None: one card) as a mesh,
    over ranks when a group is up."""
    if spec is None:
        return make_card_mesh()
    sizes, names = spec
    if dist.is_initialized():
        return rank_mesh(sizes, names)
    return Mesh(sizes, names)


@contextlib.contextmanager
def _ranks_for(mesh: Mesh):
    """A ``fake_world`` of the mesh's size unless one is up or the mesh
    is one card."""
    if mesh.size == 1 or dist.is_initialized():
        yield mesh
        return
    with fake_world(mesh.size):
        yield rank_mesh(mesh.axis_sizes, mesh.axis_names)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            mesh="card", variant: str = "baseline", out_dir: str = OUT_DIR,
            verbose: bool = True) -> dict:
    """Measure one pair (or record why it is skipped) and write its
    artifact. ``mesh`` is ``parse_mesh``'s text or a ``Mesh``; a mesh of
    several cards runs in a ``fake_world`` of its size (or the group
    that is up)."""
    if not isinstance(mesh, Mesh):
        mesh = _sized_mesh(parse_mesh(mesh, multi_pod=multi_pod))
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    tag = _tag(arch, shape_name, variant, mesh_name(mesh))
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
               "variant": variant, "status": "skipped", "reason": reason}
        _save(out_dir, tag, rec)
        if verbose:
            print(f"[skip] {tag}: {reason}")
        return rec
    with _ranks_for(mesh) as ranked:
        rec = measure(cfg, shape, variant=variant,
                      mesh=None if ranked.size == 1 else ranked)
    _save(out_dir, tag, rec)
    if verbose:
        terms = rec["roofline"]
        print(f"[ok] {tag}: meta run {rec['compile_s']:.1f}s "
              f"dominant={terms['dominant']} "
              f"compute={terms['compute_s']*1e3:.2f}ms "
              f"memory={terms['memory_s']*1e3:.2f}ms "
              f"coll={terms['collective_s']*1e3:.2f}ms "
              f"peakHBM={rec['per_device']['peak_bytes']/1e9:.2f}GB")
    return rec


def _save(out_dir, tag, rec):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=float)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every registered arch x the four shapes")
    ap.add_argument("--mesh", default="card",
                    help="card (one H100), production ((16, 16); (2, 16, "
                         "16) with --multi-pod), or sizes data,model / "
                         "pod,data,model")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the two-pod mesh (--mesh production implied)")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip pairs whose artifact JSON already exists")
    args = ap.parse_args(argv)
    spec = parse_mesh(args.mesh, multi_pod=args.multi_pod)

    if args.all:
        pairs = [(a, s.name) for a in sorted(list_configs()) for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        pairs = [(args.arch, args.shape)]
    failures = []
    world = _sized_mesh(spec)
    with _ranks_for(world) as mesh:
        for a, s in pairs:
            tag = _tag(a, s, args.variant, mesh_name(mesh))
            if args.skip_existing and os.path.exists(
                    os.path.join(args.out, tag + ".json")):
                print(f"[skip-existing] {tag}")
                continue
            try:
                run_one(a, s, mesh=mesh, variant=args.variant,
                        out_dir=args.out)
            except Exception as e:  # noqa: BLE001 — report, keep sweeping
                failures.append((a, s, repr(e)))
                print(f"[FAIL] {a} {s}: {e}")
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")


if __name__ == "__main__":
    main()
