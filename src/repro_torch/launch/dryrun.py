"""Dry run over one H100: build each (arch x input shape) step on meta
tensors and read its FLOPs, bytes and roofline terms (port of
``repro.launch.dryrun``).

The reference lowers and compiles each program for a 256-chip TPU v5e
mesh and reads XLA's cost and memory analyses. The port runs the same
step, the one its entry points run (``make_train_step`` with AdamW, or
``Model.prefill`` / ``decode_step`` on bf16 weights, ``impl="xla"``), on
the ``meta`` device, where every tensor has a shape and a dtype and no
storage, so it needs no card and allocates nothing:

* ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of every
  matmul-class op (2·M·N·K a product), in every layer and every chunk:
  Python loops run each one, so there is no depth extrapolation (the
  reference's ``_cost_pass`` and ``_scale_coll``) and no cost mode: the
  reference re-lowers with ``REPRO_COST_MODE=1`` (``scan_config``)
  because XLA counts a loop body once whatever its trip count, and the
  port counts the program it runs as it is. Elementwise work is
  not counted; it belongs to the memory term, which is the analytic
  ``roofline_model.traffic_bytes``, as in the reference.
* ``LiveBytes``, a ``TorchDispatchMode``, adds each new output storage's
  bytes to a live count and subtracts them when the storage is freed;
  its peak is ``temp_bytes`` (the step's outputs included).

The artifact has the reference's keys, so ``benchmarks/roofline.py``'s
``roofline_table(..., mesh="h100x1")`` reads it unchanged. The keys that
have no counterpart are null: ``xla_bytes_accessed_rolled``,
``collectives.rolled_count`` and ``cost_compile_s``. ``compile_s`` is
the seconds of the meta run. ``peak_bytes`` is ``argument_bytes +
temp_bytes``: the step's arguments stay alive beside everything it
allocates (nothing is donated). The collectives are all zeros: one card
issues none (``hlo_analysis.no_collectives``).

Only one card is covered: ``multi_pod=True`` (``--multi-pod``), or a mesh
over more than one card, raises ``NotImplementedError`` until the
four-card placement exists, as ``sharding.specs.to_shardings`` does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # 11 x 4 pairs
Artifacts land in
artifacts/dryrun_torch/<arch>__<shape>__h100x1[__variant].json.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
import weakref
from functools import partial

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as _tree
from repro_torch.configs import (SHAPES, get_config, get_shape,
                                 list_configs, shape_applicable)
from repro_torch.launch.hlo_analysis import no_collectives, roofline_terms
from repro_torch.launch.mesh import CARD_MESH_NAME, H100, make_card_mesh
from repro_torch.launch.roofline_model import _n_params, traffic_bytes
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.training import make_train_step

OUT_DIR = "artifacts/dryrun_torch"


def _card_mesh(mesh=None, *, multi_pod: bool = False):
    """``mesh`` (default: one card), refused when it spans more cards."""
    mesh = make_card_mesh() if mesh is None else mesh
    if multi_pod or mesh.size > 1:
        what = "two pods" if multi_pod else f"a mesh of {mesh.size} cards"
        raise NotImplementedError(
            f"the dry run covers one card, not {what}: that waits for the "
            "four-card placement (ROADMAP.md)")
    return mesh


def _shape(shape):
    return get_shape(shape) if isinstance(shape, str) else shape


def _serve_params(model) -> dict:
    """The meta masters cast to bf16: the serving weights."""
    return _tree.tree_map(
        lambda a: a.to(torch.bfloat16) if a.dtype == torch.float32 else a,
        model.abstract_params())


def build_dryrun(arch, shape, *, multi_pod: bool = False, mesh=None):
    """Returns ``(mesh, fn, args)``: ``fn(*args)`` runs one step of
    ``shape.mode`` on meta tensors.

    ``arch`` is a registry name or a ``ModelConfig``; ``shape`` a name of
    ``SHAPES`` or an ``InputShape``. A train shape runs
    ``make_train_step(model, adamw(1e-4))`` on the fp32 masters and
    ``opt.init`` of them; a prefill runs ``model.prefill`` on the bf16
    weights with ``cache_len_for(seq_len)`` slots; a decode runs
    ``model.decode_step`` on ``input_specs``' cache, token and position.
    """
    mesh = _card_mesh(mesh, multi_pod=multi_pod)
    cfg = get_config(arch) if isinstance(arch, str) else arch
    return (mesh,) + _step(_meta_model(cfg), _shape(shape))


def _meta_model(cfg):
    """``cfg``'s model on meta, whose ``abstract_params`` tree is built
    once (seconds for the large configs) and shared by the step, the
    traffic model and the FLOP estimate."""
    model = build_model(cfg, impl="xla", device="meta")
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


class LiveBytes(TorchDispatchMode):
    """Live bytes of the storages the ops under this mode allocate.

    An op output whose storage is new (not one of the op's inputs', not
    one already counted) adds its bytes; each tensor that holds a counted
    storage is watched, and when the last of them is freed the bytes go.
    A tensor's Python object lives as long as its C++ tensor (autograd's
    saved tensors included), so the count follows what the program keeps.
    Works alike on meta and on real tensors."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._bytes: dict = {}      # storage key -> bytes
        self._holders: dict = {}    # storage key -> live watched tensors

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
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
    """The tensors of nested tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _flat(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _flat(x)


def count(fn, args) -> dict:
    """Run ``fn(*args)`` under ``FlopCounterMode`` and ``LiveBytes``:
    ``{"flops", "argument_bytes", "output_bytes", "temp_bytes"}``."""
    arg_st = _storages_of(args)
    with FlopCounterMode(display=False) as fc, LiveBytes() as live:
        out = fn(*args)
    out_st = {k: n for k, n in _storages_of(out).items() if k not in arg_st}
    return {"flops": int(fc.get_total_flops()),
            "argument_bytes": sum(arg_st.values()),
            "output_bytes": sum(out_st.values()), "temp_bytes": live.peak}


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


def measure(arch, shape, *, variant: str = "baseline") -> dict:
    """The artifact record of one (arch, shape[, variant]) on one card;
    ``arch`` a name or a ``ModelConfig``, ``shape`` a name or an
    ``InputShape`` (chip_smoke.py passes the shapes it times)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = _shape(shape)
    t0 = time.time()
    model = _meta_model(cfg)
    if variant == "baseline":
        mesh = _card_mesh()
        fn, args = _step(model, shape)
    else:
        from repro_torch.launch import variants
        mesh, fn, args = variants.build_variant(cfg, shape, variant,
                                                model=model)
    counts = count(fn, args)
    run_s = time.time() - t0
    n_dev = mesh.size
    flops = float(counts["flops"])
    traffic = traffic_bytes(model, shape, n_devices=n_dev,
                            dp=mesh.shape.get("data", 1),
                            tp=mesh.shape.get("model", 1))
    coll = no_collectives()
    terms = roofline_terms(flops, traffic["total"], coll, H100,
                           n_chips=n_dev)
    mf, n_params = model_flops_estimate(cfg, shape, model=model)
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": CARD_MESH_NAME,
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


def _tag(arch: str, shape_name: str, variant: str) -> str:
    return f"{arch}__{shape_name}__{CARD_MESH_NAME}" + (
        "" if variant == "baseline" else f"__{variant}")


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            variant: str = "baseline", out_dir: str = OUT_DIR,
            verbose: bool = True) -> dict:
    """Measure one pair (or record why it is skipped) and write its
    artifact."""
    _card_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    tag = _tag(arch, shape_name, variant)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": CARD_MESH_NAME,
               "variant": variant, "status": "skipped", "reason": reason}
        _save(out_dir, tag, rec)
        if verbose:
            print(f"[skip] {tag}: {reason}")
        return rec
    rec = measure(cfg, shape, variant=variant)
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
    ap.add_argument("--multi-pod", action="store_true",
                    help="raises: the dry run covers one card")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip pairs whose artifact JSON already exists")
    args = ap.parse_args(argv)
    _card_mesh(multi_pod=args.multi_pod)

    if args.all:
        pairs = [(a, s.name) for a in sorted(list_configs()) for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        pairs = [(args.arch, args.shape)]
    failures = []
    for a, s in pairs:
        tag = _tag(a, s, args.variant)
        if args.skip_existing and os.path.exists(
                os.path.join(args.out, tag + ".json")):
            print(f"[skip-existing] {tag}")
            continue
        try:
            run_one(a, s, variant=args.variant, out_dir=args.out)
        except Exception as e:  # noqa: BLE001 — report, keep sweeping
            failures.append((a, s, repr(e)))
            print(f"[FAIL] {a} {s}: {e}")
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")


if __name__ == "__main__":
    main()
