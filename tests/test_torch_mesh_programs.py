"""The model zoo's programs over a mesh of ranks against the same
programs in one process.

A gloo world of 4 ranks, (data 2, model 2): for one reduced config of
each family (dense, MoE, MLA, hybrid SSM with meta tokens, qk-norm with
windows, the encoder-decoder), from one seed on every rank:

* a train step (``make_train_step``, AdamW) on ``DTensor`` params placed
  FSDP x TP by ``param_pspecs`` and a batch over "data": the loss within
  1e-5 and every updated leaf within 1e-4 of the one-process step (the
  twin rule at lr 3e-4; the sums run in another order);
* a prefill and two decode steps on TP-placed serving weights: logits
  within 1e-4, and the caches it writes in place over the ranks (the
  ring write, the SSM state, the enc-dec cross cache) equal to the
  one-process caches within 1e-5.

This is what the dry run over the production meshes runs, on real
tensors: the sharding rules, the redistributions DTensor inserts, the
sharded MoE dispatch, the shard-local ring writes and the views gathered
where a dim splits unevenly (``sharded_program``).

olmoe-1b-7b's train step with the group-local MoE dispatch
(``REPRO_MOE_GROUPED=2``) over the ranks against one process, as above.

A decode whose cache is sharded on its slots: reduced fedforecast-100m
(three layers), the one-process prefill's cache placed by ``cache_pspecs``, two decode
steps over the ranks against the same steps in one process. With batch
4, ``pos`` has its slots over "model" (its innermost dim); with batch 1,
which "data" does not divide, every leaf has its slots over "data" (the
long-ring layout). Logits within 1e-4, caches within 1e-5, and
``record_collectives`` sees no all-gather of a cache leaf's size (one
layer's or the stack's).
"""
import pytest

from test_torch_mesh_world import run_world

ARCHS = ["fedforecast-100m", "olmoe-1b-7b", "minicpm3-4b", "hymba-1.5b",
         "gemma3-4b", "seamless-m4t-large-v2"]
B, S = 4, 24
LOSS_TOL, PARAM_TOL, LOGIT_TOL, CACHE_TOL = 1e-5, 1e-4, 1e-4, 1e-5


def _batch(cfg, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return {"frames": torch.from_numpy(rng.normal(
                    size=(B, S, cfg.frontend.d_frontend)).astype(np.float32)),
                "tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab, (B, S)).astype(np.int64))}
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S)).astype(np.int64))}
    if cfg.frontend is not None:
        out["patches"] = torch.from_numpy(rng.normal(size=(
            B, cfg.frontend.num_tokens, cfg.frontend.d_frontend)).astype(
                np.float32))
    return out


def _max_err(a, b):
    from torch.distributed.tensor import DTensor
    from repro_torch import tree as _tree
    err = 0.0
    for x, y in zip(_tree.leaves(a), _tree.leaves(b)):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        err = max(err, float((x.double() - y.double()).abs().max()))
    return err


def _arch_checks(arch):
    import torch
    from repro_torch import tree as _tree
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding import cache_pspecs, param_pspecs
    from repro_torch.sharding.mesh import mesh_scope, sharded_program
    from repro_torch.sharding.specs import NamedSharding, P, place
    from repro_torch.training import make_train_step

    mesh = make_host_mesh(2, 2)
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    batch = _batch(cfg, 1)
    opt = adamw(3e-4)
    step = make_train_step(model, opt)
    out = {}

    def on(tree, specs):
        return place(tree, _tree.tree_map(lambda s: NamedSharding(mesh, s),
                                          specs))

    def batch_on(b):
        return {k: NamedSharding(mesh, P("data", *([None] * (v.dim() - 1)))
                                 ).place(v) for k, v in b.items()}

    ref = step(params, opt.init(params), batch)
    d_params = on(params, param_pspecs(params, mesh))
    with mesh_scope(mesh):
        got = step(d_params, opt.init(d_params), batch_on(batch))
    out["loss"] = abs(float(got[2]["loss"].full_tensor() - ref[2]["loss"]))
    out["params"] = _max_err(got[0], ref[0])
    out["moments"] = _max_err(got[1]["m"], ref[1]["m"])

    cache_len = S + 4
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, cache_len)
        d_serve = on(params, param_pspecs(params, mesh, "serve"))
        with mesh_scope(mesh), sharded_program(_tree.leaves(d_serve)):
            d_logits, d_cache = model.prefill(d_serve, batch_on(batch),
                                              cache_len)
            specs = cache_pspecs(d_cache, mesh, batch=B)
            d_cache = _tree.tree_map(
                lambda c, s: NamedSharding(mesh, s).constrain(c)
                if hasattr(c, "placements") else c, d_cache, specs)
        out["prefill"] = _max_err(d_logits, logits)
        pos = torch.full((B, 1), S, dtype=torch.int32)
        if cfg.is_encoder_decoder:
            pos = torch.full((B, 1), 1, dtype=torch.int32)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        errs = []
        for i in range(2):
            logits, cache = model.decode_step(params, cache, tok, pos + i)
            with mesh_scope(mesh), sharded_program(_tree.leaves(d_serve)):
                d_logits, d_cache = model.decode_step(
                    d_serve, d_cache, NamedSharding(mesh, P("data", None))
                    .place(tok), NamedSharding(mesh, P("data", None)).place(
                        pos + i))
            errs.append(_max_err(d_logits, logits))
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        out["decode"] = max(errs)
        out["cache"] = _max_err(d_cache, cache)
    return out


SLOT_BATCHES = {"model": 4, "data": 1}


def _slot_decode_checks(batch):
    import dataclasses

    import torch
    from torch.distributed.tensor import Shard
    from repro_torch import tree as _tree
    from repro_torch.configs import get_config
    from repro_torch.launch.hlo_analysis import record_collectives
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import cache_pspecs, param_pspecs
    from repro_torch.sharding.mesh import mesh_scope, sharded_program
    from repro_torch.sharding.specs import NamedSharding, P, place

    mesh = make_host_mesh(2, 2)
    # three layers: no stacked leaf has the bytes of the (B, H, T) f32
    # scores whose softmax rows the decode may gather
    cfg = dataclasses.replace(get_config("fedforecast-100m").reduced(),
                              n_layers=3)
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    toks = _batch(cfg, 2)["tokens"][:batch]
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, S + 4)
        d_serve = place(params, _tree.tree_map(
            lambda s: NamedSharding(mesh, s),
            param_pspecs(params, mesh, "serve")))
        specs = cache_pspecs(cache, mesh, batch=batch)
        d_cache = place(_tree.tree_map(lambda a: a.clone(), cache),
                        _tree.tree_map(lambda s: NamedSharding(mesh, s),
                                       specs))
        slot_axes = [ax for ax, pl in zip(mesh.axis_names,
                                          d_cache["attn"]["pos"].placements)
                     if pl == Shard(2)]
        leaf_bytes = set()
        for a in _tree.leaves(cache):
            n = a.numel() * a.element_size()
            leaf_bytes |= {n, n // a.shape[0]}
        lead = "data" if batch % 2 == 0 else None
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        pos = torch.full((batch, 1), S, dtype=torch.int32)
        errs, gathers = [], []
        for i in range(2):
            logits, cache = model.decode_step(params, cache, tok, pos + i)
            with mesh_scope(mesh), sharded_program(_tree.leaves(d_serve)), \
                    record_collectives() as rec:
                d_logits, d_cache = model.decode_step(
                    d_serve, d_cache,
                    NamedSharding(mesh, P(lead, None)).place(tok),
                    NamedSharding(mesh, P(lead, None)).place(pos + i))
            gathers += [op["bytes"] for op in rec.summary()["ops"]
                        if op["kind"] == "all-gather"]
            errs.append(_max_err(d_logits, logits))
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    return {"slot_axes": slot_axes, "decode": max(errs),
            "cache": _max_err(d_cache, cache),
            "leaf_gathers": sorted(set(gathers) & leaf_bytes)}


def _grouped_train_checks():
    """olmoe-1b-7b's train step with the group-local dispatch
    (``REPRO_MOE_GROUPED=2``, one group a "data" rank) over the ranks
    against the same dispatch in one process."""
    import os
    from repro_torch import tree as _tree
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding import param_pspecs
    from repro_torch.sharding.mesh import mesh_scope
    from repro_torch.sharding.specs import NamedSharding, P, place
    from repro_torch.training import make_train_step

    mesh = make_host_mesh(2, 2)
    cfg = get_config("olmoe-1b-7b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    batch = _batch(cfg, 1)
    opt = adamw(3e-4)
    step = make_train_step(model, opt)
    os.environ["REPRO_MOE_GROUPED"] = "2"
    try:
        ref = step(params, opt.init(params), batch)
        d_params = place(params, _tree.tree_map(
            lambda s: NamedSharding(mesh, s), param_pspecs(params, mesh)))
        d_batch = {k: NamedSharding(mesh, P("data", None)).place(v)
                   for k, v in batch.items()}
        with mesh_scope(mesh):
            got = step(d_params, opt.init(d_params), d_batch)
    finally:
        del os.environ["REPRO_MOE_GROUPED"]
    return {"loss": abs(float(got[2]["loss"].full_tensor()
                              - ref[2]["loss"])),
            "params": _max_err(got[0], ref[0]),
            "moments": _max_err(got[1]["m"], ref[1]["m"])}


def _rank_checks(rank, world):
    out = {arch: _arch_checks(arch) for arch in ARCHS}
    out["grouped"] = _grouped_train_checks()
    out["slots"] = {ax: _slot_decode_checks(b)
                    for ax, b in SLOT_BATCHES.items()}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(_rank_checks, 4, tmp_path_factory.mktemp("programs"))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_over_ranks_matches_one_process(world, arch):
    for r in world:
        got = r[arch]
        assert got["loss"] <= LOSS_TOL, got
        assert got["params"] <= PARAM_TOL and got["moments"] <= PARAM_TOL, got


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_over_ranks_match_one_process(world, arch):
    for r in world:
        got = r[arch]
        assert got["prefill"] <= LOGIT_TOL and got["decode"] <= LOGIT_TOL, got
        assert got["cache"] <= CACHE_TOL, got


@pytest.mark.parametrize("axis", sorted(SLOT_BATCHES))
def test_decode_on_slot_sharded_cache_matches_and_gathers_no_leaf(world,
                                                                   axis):
    for r in world:
        got = r["slots"][axis]
        assert got["slot_axes"] == [axis], got
        assert got["decode"] <= LOGIT_TOL and got["cache"] <= CACHE_TOL, got
        assert got["leaf_gathers"] == [], got


def test_grouped_moe_train_step_over_ranks_matches_one_process(world):
    for r in world:
        got = r["grouped"]
        assert got["loss"] <= LOSS_TOL, got
        assert got["params"] <= PARAM_TOL and got["moments"] <= PARAM_TOL, got
